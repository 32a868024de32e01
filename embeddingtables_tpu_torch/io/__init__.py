"""The input pipeline: native parsing, native synthesis, prefetch and the
copy to the card (`loader`, `synth`), and a Criteo-format file writer
(`criteo_file`)."""
from .loader import (CriteoFileLoader, DevicePrefetcher, PrefetchLoader,
                     native_available, native_parse_batch, parallel_batches)
from .synth import NativeSyntheticCriteo, native_synth_available

__all__ = ["CriteoFileLoader", "DevicePrefetcher", "PrefetchLoader",
           "native_available", "native_parse_batch", "parallel_batches",
           "NativeSyntheticCriteo", "native_synth_available"]
