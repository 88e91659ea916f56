from .cross_modal_generation import CrossModalPromptDataset
from .cross_modal_generation import generate as cm_generate
from .cross_modal_metric import CrossModalMetricDataset, cm_storycloze
from .generative_metric import PromptDataset, asr_perplexity, generate, llm_as_judge
from .modelling_metric import (ModellingMetricDataset, SalmonDataset, salmon, sblimp,
                               storycloze, swuggy)

__all__ = ["CrossModalPromptDataset", "cm_generate", "CrossModalMetricDataset",
           "cm_storycloze", "PromptDataset", "asr_perplexity", "generate", "llm_as_judge",
           "ModellingMetricDataset",
           "SalmonDataset", "salmon", "sblimp", "storycloze", "swuggy"]
