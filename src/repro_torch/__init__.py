"""Ocean SpGEMM in PyTorch, with hand-written CUDA kernels for Hopper.

The package mirrors ``repro`` (the JAX/Pallas reference) module by module:
``core`` holds the analysis -> prediction -> binning -> execution pipeline,
``kernels`` the CUDA kernels with their plain PyTorch versions, ``obs`` the
tracing and accuracy telemetry. Entry points run on the device their
inputs live on; constructors default to ``device="cuda"`` and raise when
no GPU is present instead of carrying on on the CPU.
"""
