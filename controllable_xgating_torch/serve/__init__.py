from controllable_xgating_torch.serve.engine import CaptionResult, ServingEngine

__all__ = ["CaptionResult", "ServingEngine"]
