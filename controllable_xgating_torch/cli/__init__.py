"""The port's command-line entry points: `caption`, `eval` and `train`
(XE stages), run as `python -m controllable_xgating_torch.cli.<name>`."""
