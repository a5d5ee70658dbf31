"""The paper's own §5.2 task: PageRank on the Yahoo! webmap-2002 snapshot
(1.41B vertices, 70 GB), as a Pregel workload description."""

from repro_torch.core.planner import PregelStats

STATS = PregelStats(
    n_vertices=1_413_511_393,
    n_edges=8_050_112_169,
    vertex_bytes=8,
    msg_bytes=8,
)

CONFIG = STATS
