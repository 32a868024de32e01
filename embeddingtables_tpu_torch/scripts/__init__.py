"""The training command lines (counterparts of the JAX package's
`scripts/train_{dlrm,dcn,deepfm,two_tower}.py`), each run as a module:

    python -m embeddingtables_tpu_torch.scripts.train_dlrm --steps 200

Each takes every flag of its JAX counterpart, with the same names, defaults
and checks, and `--device` (default `cuda`; `--device cpu` runs on the
CPU). `--mesh` trains on every card, one process a card: under `torchrun`
each process joins the group from the environment; without it the command
spawns one rank per visible card itself (`_common.py`)."""
