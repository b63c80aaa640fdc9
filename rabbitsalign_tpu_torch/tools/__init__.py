"""Tools of the port (``python -m rabbitsalign_tpu_torch.tools.<name>``):
the ILP probe, which runs on the GPU, and dumpstrobes, which runs on the
host."""
