"""The LM substrate's models in PyTorch: config, layers, GQA attention,
MoE with Ocean capacity calibration, the decoder stack and the LM steps
(the port of ``repro.models``, serving half)."""
