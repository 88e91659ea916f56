from .generative_metric import PromptDataset, generate
from .modelling_metric import (ModellingMetricDataset, SalmonDataset, salmon, sblimp,
                               storycloze, swuggy)

__all__ = ["PromptDataset", "generate", "ModellingMetricDataset", "SalmonDataset", "salmon",
           "sblimp", "storycloze", "swuggy"]
