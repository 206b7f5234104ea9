"""Command-line tools of the port (`python -m controllable_xgating_torch.tools.<name>`)."""
