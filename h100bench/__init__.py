"""The benchmark of the PyTorch / CUDA port (``repro_torch``) on one NVIDIA
H100: ``python3 h100bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  See ``README.md``."""
