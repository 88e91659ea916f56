from .dataset import (Batcher, TokenDataset, init_dataset, load_token_dataset, pack_into_rows,
                      pad_into_rows, parse_single_dataset)
from .pack import bestfit_pack, greedy_pack, greedy_pack_count

__all__ = ["Batcher", "TokenDataset", "init_dataset", "load_token_dataset", "pack_into_rows",
           "pad_into_rows", "parse_single_dataset", "bestfit_pack", "greedy_pack",
           "greedy_pack_count"]
