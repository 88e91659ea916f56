from .dataset import (Batcher, TokenDataset, init_dataset, load_token_dataset, pack_into_rows,
                      pad_into_rows, parse_single_dataset)
from .pack import bestfit_pack, greedy_pack, greedy_pack_count
from .preference import get_repetition_filter_fn, init_preference_optimization_dataset
from .prepare import prepare_tokens_file, process_feature_line

__all__ = ["Batcher", "TokenDataset", "init_dataset", "load_token_dataset", "pack_into_rows",
           "pad_into_rows", "parse_single_dataset", "bestfit_pack", "greedy_pack",
           "greedy_pack_count", "get_repetition_filter_fn",
           "init_preference_optimization_dataset", "prepare_tokens_file",
           "process_feature_line"]
