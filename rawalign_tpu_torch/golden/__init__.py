"""Copy of rawalign_tpu/golden/__init__.py for the port.

Golden model: NumPy/Python implementations replicating the reference
semantics operation-for-operation.

These are the correctness oracle for the TPU kernels (every device kernel
is tested against this package) and double as executable documentation of
the algorithm. They are NOT the production path — see rawalign_tpu_torch.map /
rawalign_tpu_torch.signal / rawalign_tpu_torch.seeds for the batched device versions.
"""
