"""ZapRAID controller over simulated ZNS drives (host control plane in numpy,
stripe codec on the device through ``repro_torch.kernels``)."""
