"""The benchmark of ``fal_net_torch`` on one NVIDIA H100: ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
BENCHMARK.json at the repository's root names the cells and metrics; the
files under this directory are found by those names (see run.py)."""
