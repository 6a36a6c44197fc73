"""Multi-process execution of the port: one rank a device, on
torch.distributed (the counterpart of quaff_tpu/parallel/)."""
