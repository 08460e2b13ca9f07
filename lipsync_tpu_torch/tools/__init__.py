"""The port's tools, each run as ``python -m lipsync_tpu_torch.tools.<name>``:
the operational tier (the JAX package's ``scripts/`` of the same names:
synthetic data, precompute, validation, calibration, evaluation, data
hygiene and the synthetic end-to-end run) and the port's own measurement
scripts."""
