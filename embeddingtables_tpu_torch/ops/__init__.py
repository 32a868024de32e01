from .lookup import lookup, lookup_oracle
from .ensemble import StackedTables

__all__ = ["lookup", "lookup_oracle", "StackedTables"]
