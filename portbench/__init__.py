"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
See README.md beside this file."""
