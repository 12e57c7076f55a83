"""The benchmark of the PyTorch and CUDA port (``repro_torch``); run it
as ``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of the repository."""
