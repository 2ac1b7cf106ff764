"""Ocean's SpGEMM pipeline on PyTorch tensors (see ``workflow.ocean_spgemm``)."""
