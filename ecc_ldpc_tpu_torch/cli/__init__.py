"""Command-line entry point of the port: python -m ecc_ldpc_tpu_torch.cli."""
