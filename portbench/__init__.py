"""The benchmark of `embeddingtables_tpu_torch` on NVIDIA GPUs.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line last. Everything that belongs to one configuration, traffic mix,
family, kind of traffic or per-layer metric sits in a file of its own that
the harness finds by the name `BENCHMARK.json` gives:

  configs/<config>.json      the configuration as it is run
  families/<family>.py       how the port builds and trains the
                             family, and its plain f32 reference
  traffic/<mix>.json         parameters of the traffic generator
  kinds/<kind>.py            the set-up, window and check of a traffic kind
  metrics/<metric>.py        the reader of one per-layer metric
  limits/<cell>.json         the limits of the numbers `correct` compares

No module of this package imports `jax` or the JAX package.
"""
