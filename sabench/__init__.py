"""The benchmark of the PyTorch and CUDA suffix-array system (`repro_torch`).

`python3 sabench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json`. Everything the
benchmark knows of a cell is data found by name: the configuration file
the cell names, `traffic/<mix>.json`, the driver `drivers/<kind>.py` of
the mix's kind, and one reader `metrics/<metric>.py` per metric.
"""
