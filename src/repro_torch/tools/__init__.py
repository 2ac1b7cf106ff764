"""Scripts of the port: measurements on a CUDA card, and the trace export."""
