"""Probes: scripts that measure design questions of the port's kernels on the
card, run as modules (`python -m fastposecnn_tpu_torch.probes.<name>`)."""
