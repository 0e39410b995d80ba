"""The benchmark of ``repro_torch``: the DD branch-and-bound solver on
Pisinger's knapsack series (``python3 bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``)."""
