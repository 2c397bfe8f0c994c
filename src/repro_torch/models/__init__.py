"""The language models of the port: config, layers, attention and the dense
decoder LM, as ``nn.Module``s over the kernels of :mod:`repro_torch.kernels`."""
