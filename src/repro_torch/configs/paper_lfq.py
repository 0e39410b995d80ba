"""The paper's own configuration: lock-free bulk work-stealing queue
parameters + DD-solver instance defaults, mirroring §IV's evaluation
(queue of initial size 10,000; batch sizes 1..1024; steal proportions
10..60%; DAG workloads of 2.5M / 300M nodes — the large one is scaled to
this container in benchmarks, the full size is kept for the dry-run
planner)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LFQConfig:
    queue_capacity: int = 16_384        # device ring capacity per worker
    queue_limit: int = 2                # paper's ``_queue_limit_``
    max_steal: int = 8_192              # static bulk-transfer upper bound
    steal_proportion: float = 0.5       # steal-half default (paper §V)
    low_watermark: int = 1              # "nearly drained" trigger (§II.B)
    high_watermark: int = 8
    push_batch_sizes: tuple = (1, 128, 512, 1024)       # Fig. 6
    steal_proportions: tuple = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6)  # Figs. 7-8
    bench_initial_size: int = 10_000    # Fig. 7 setup
    dag_nodes_small: int = 2_500_000    # Fig. 9
    dag_nodes_large: int = 300_000_000  # Fig. 9 (scaled on CPU)


CONFIG = LFQConfig()
