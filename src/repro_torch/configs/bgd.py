"""The paper's own §5.1 task: Batch Gradient Descent on the Yahoo! News
dataset (16.5M records, ~80 GB, 16 MB (gradient, loss) statistic), as an
IMRU workload description consumed by the planner."""

from repro_torch.core.planner import IMRUStats

# Statistics exactly as reported in the paper.
STATS = IMRUStats(
    n_records=16_557_921,
    record_bytes=(80 * 2**30) // 16_557_921,   # ~5.2 KB/record sparse
    model_bytes=16 * 2**20,                     # the 16 MB model vector
    stat_bytes=16 * 2**20,                      # (gradient, loss) payload
    flops_per_record=2.0 * 4000,                # ~4k nnz per sparse vector
)

CONFIG = STATS  # --arch bgd resolves to the workload stats
