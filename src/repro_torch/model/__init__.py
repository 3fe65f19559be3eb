"""Model: layers, GQA attention on the FuseMax kernels, the decoder."""
