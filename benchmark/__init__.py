"""The benchmark of the PyTorch/CUDA port (starcat_torch): one cell run once
by ``python benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  See benchmark/README.md."""
