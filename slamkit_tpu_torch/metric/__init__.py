from .generative_metric import PromptDataset, generate

__all__ = ["PromptDataset", "generate"]
