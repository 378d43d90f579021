"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`run.py` runs one cell of `BENCHMARK.json` once; the rest of this package
is the yardstick: cell lookup and the run's record (`bench`), the kind
runners (`kinds/<kind>.py`), the per-layer metric readers
(`metrics/<metric>.py`), the frozen work counts (`work`), the plain
reference (`reference`) and the data files (`configs`, `traffic`,
`checks`).  See README.md.
"""
