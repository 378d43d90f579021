"""PyTorch/CUDA port of the BandMap mapper (`repro` is the JAX
reference).

The port mirrors `repro`'s layout module for module and imports nothing
of it: each module it needs is its own copy.  Its entry point is
`repro_torch.core.map_dfg`, whose default portfolio engine
(``engine="device"``) runs the lock-step SBTS search on a CUDA device
through the hand-written kernel in `repro_torch.kernels.sbts_step`.
Pass ``device="cpu"`` to run the same engine on the host (its kernel's
plain torch version), or ``engine="numpy"`` for the numpy portfolio.
"""
