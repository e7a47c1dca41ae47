"""Data parallelism over processes, one device each (port of
``cat_tpu/parallel``).

The JAX package runs one SPMD program over a device mesh: parameters
replicated, the batch sharded, and every step computes the single-device
function of the GLOBAL batch (``tests/test_sharding.py``).  Here each rank
is a process with its own device, joined by ``torch.distributed``:

  * ``multihost``: the process group (NCCL on CUDA, gloo on the CPU), the
    (rank, world) shard of the data, the host-side merges of the FID
    moments and the mIoU confusion matrices;
  * ``mesh``: the device of a rank, and ``--n_devices k`` as k ranks
    spawned on one host;
  * ``collectives``: the collectives inside a step (rows gathered for KA
    and the image pool, sums for batch-norm statistics, both with their
    gradients), the averaged gradients' all-reduce, the metrics' means,
    and the broadcast of the replicas after setup.

Without a process group (``--n_devices 1``, the default) no collective
runs and every function returns its input.
"""
