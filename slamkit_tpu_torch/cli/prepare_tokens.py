"""Stage 2 on the port: features jsonl -> tokens jsonl {file_name, audio_repr}.

    python -m slamkit_tpu_torch.cli.prepare_tokens data_path=<features.jsonl> \
        out_path=<tokens.jsonl> [+device=cpu]

The counterpart of `cli/prepare_tokens.py`, on the repo's `config/` tree
(prepare_tokens.yaml: the feature extractor's config only, no weights):
the requires_meta merge, a failing line skipped, a thread pool, output
appended to out_path byte for byte as the JAX package writes it. The stage
does no device work, but its tokeniser's extractor is bound to a device like
every entry point's: the card, unless `+device=cpu`.
"""
import logging
import os

from ..config import main
from ..data.prepare import prepare_tokens_file

logger = logging.getLogger(__name__)


@main(config_name="prepare_tokens", config_path="../../config")
def prepare_tokens(cfg):
    from ..tokeniser import tokeniser_factory
    from ..utils.device import DEFAULT_DEVICE

    device = "cpu" if cfg.get("device", None) == "cpu" else DEFAULT_DEVICE
    tokeniser = tokeniser_factory(cfg.tokeniser, device=device)
    requires_meta = bool(cfg.tokeniser.get("requires_meta", False))
    os.makedirs(os.path.dirname(os.path.abspath(cfg.out_path)), exist_ok=True)
    n = prepare_tokens_file(cfg.data_path, cfg.out_path, tokeniser,
                            requires_meta=requires_meta, meta_path=cfg.get("meta_path", None),
                            n_threads=cfg.get("n_threads", 32))
    logger.info("Wrote %d lines to %s", n, cfg.out_path)
    return n


if __name__ == "__main__":
    prepare_tokens()
