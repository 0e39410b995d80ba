"""The benchmark of ``repro_torch`` (``python3 bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``): each cell's
configuration names its kind, the module of ``bench/kinds/`` that says
what runs and how it is checked; so far the DD branch-and-bound solver on
Pisinger's knapsack series (``bench/kinds/dd_knapsack.py``)."""
