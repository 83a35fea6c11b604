"""The benchmark of the PyTorch and CUDA port (``repro_torch``); see
README.md. Run one cell with ``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``."""
