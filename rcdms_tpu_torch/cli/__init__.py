"""Command-line entry points: `python -m rcdms_tpu_torch.cli.generate` and
`python -m rcdms_tpu_torch.cli.evaluate`."""
