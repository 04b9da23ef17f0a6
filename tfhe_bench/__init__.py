"""The benchmark of rs_tfhe_tpu_torch on an NVIDIA H100: `python3 -m
tfhe_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(run.py). Cells, metrics and bounds are in BENCHMARK.json at the repository
root; configurations in configs/, traffic mixes in traffic/, one reader a
metric in metrics/."""
