"""Multi-device scaling: one process per device over ``torch.distributed``.

Counterpart of genomeworks_tpu/parallel. Replaces the reference's
parallelism machinery (CUDA streams and one CPU worker thread per GPU with
thread-safe work queues, cudamapper/src/main.cu:453-594) with one process
per card in a process group: batches of windows, alignments and query
reads are split over the ranks, and results meet through NCCL collectives
between cards (gloo where the group was made with it).
"""

from genomeworks_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    shard_batch,
    shard_range,
    pad_batch_to_multiple,
)
