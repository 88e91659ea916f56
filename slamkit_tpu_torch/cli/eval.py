"""Stage 4 on the port: score or sample a trained unit LM.

    python -m slamkit_tpu_torch.cli.eval model.pretrained_model=<checkpoint> metric=sblimp \
        metric.data_path=<dir> tokeniser.feature_extractor.pretrained_model=<HuBERT dir> \
        tokeniser.feature_extractor.kmeans_path=<centroids.npy> [device=cpu] [overrides ...]

The counterpart of `cli/eval.py`, on the repo's `config/` tree (eval.yaml):
the modelling metrics (swuggy, sblimp, storycloze, salmon, with
`metric.joint_pairs`) print their scores, and `metric_type: generate`
continues WAV prompts through `metric/generative_metric.generate`. With
`metric.cross_modal: true` (cm_ms_tsc, cm_generate; the interleaved
tokeniser, e.g. `tokeniser=interleaved_hubert_25`) storycloze scores
`metric.prompt_modality` prompts against `metric.cont_modality`
continuations and generate continues them in `metric.cont_modality`. With
`metric.out_path` and a vocoder, generated waveforms are written as
`<metric_type>_<i>.<ext>` and generated text as `<metric_type>_<i>.txt`.
`metric=asr_perplexity` (GenPPL) and `metric=llm_as_judge` transcribe with
the port's Whisper (`metric.whisper_model`, a local checkpoint directory) and
score or judge with a float32 text LM (`metric.llm_name_or_path`, a local HF
directory; OpenAI names need the openai package); `metric.asr_backend` /
`metric.llm_backend` (`torch` or `jax`: both the port's own),
`metric.asr_dtype` and `metric.torch_device` (default: the eval's device)
are read as `cli/eval.py` reads them. Every `device` but `cpu` (eval.yaml's
`tpu` included) runs on the CUDA card.

`eval_mesh=N > 1` spreads every metric batch of the unit LM over N ranks
under torchrun (WORLD_SIZE must be N; gloo on the CPU), as the JAX CLI
spreads it over an N-device data mesh (`UnitLM.shard`): each rank scores
and samples its rows and gathers the rest, so every rank holds the
one-process scores and generated units. HuBERT, the vocoder, Whisper and
the judge's LM run whole on every rank, as they run unsharded in JAX. Rank
0 alone prints, writes `metric.out_path` and logs to wandb:

    python -m torch.distributed.run --nproc_per_node 4 -m slamkit_tpu_torch.cli.eval \
        metric=sblimp eval_mesh=4 ...

The ranks may span several nodes (torchrun --nnodes N --node_rank k on
each, WORLD_SIZE = N x --nproc_per_node = eval_mesh): no flag, as the
evaluation writes no checkpoint; each rank reads the metric's data itself.

`eval_fsdp=true` with `eval_mesh=N > 1` also shards the unit LM's weights
over the N ranks (ZeRO-3, `parallel/fsdp.py`), each layer gathered as it
runs, as the JAX CLI's `tlm.shard(mesh, fsdp=True)` does; the numbers are
the one-process ones.
"""
import logging
import os

from ..config import main, to_container
from ..utils.path_utils import resolve_reference_path

logger = logging.getLogger(__name__)


@main(config_name="eval", config_path="../../config")
def eval_main(cfg):
    logging.basicConfig(level=logging.INFO)
    from ..metric.metric_utils import check_backend
    from ..utils.device import DEFAULT_DEVICE

    mt = cfg.metric.metric_type
    if mt in ("asr_perplexity", "llm_as_judge"):
        check_backend("asr_backend", cfg.metric.get("asr_backend", "torch"))
        check_backend("llm_backend", cfg.metric.get("llm_backend", "torch"))
    n_mesh = int(cfg.get("eval_mesh", 0) or 0)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != max(n_mesh, 1):
        raise ValueError(f"eval_mesh={n_mesh} runs on as many ranks (torchrun "
                         f"--nproc_per_node {max(n_mesh, 1)}); this run has WORLD_SIZE={world}")
    device = "cpu" if cfg.get("device", None) == "cpu" else DEFAULT_DEVICE
    if world == 1:
        return _eval(cfg, device, None)
    from ..parallel import make_mesh, process_group

    with process_group(device) as device:
        return _eval(cfg, device, make_mesh([n_mesh]))


def _eval(cfg, device, mesh):
    """The metric on `device`, the unit LM sharded over `mesh` (or None)."""
    import numpy as np

    from ..metric.generative_metric import asr_perplexity, generate, llm_as_judge
    from ..metric.modelling_metric import salmon, sblimp, storycloze, swuggy
    from ..models.speech_lm import SpeechLM
    from ..models.unit_lm import tlm_factory
    from ..tokeniser import tokeniser_factory
    from ..vocoder.audio_vocoder import vocoder_factory

    mt = cfg.metric.metric_type
    cross_modal = bool(cfg.metric.get("cross_modal", False))
    lead = mesh is None or mesh.rank == 0   # prints, writes and logs

    if not cfg.model.pretrained_model:
        logger.warning("No pretrained model specified. please specify one with "
                       "model.pretrained_model=<path>")
    tokeniser = tokeniser_factory(cfg.tokeniser, device=device)
    if cfg.model.config_args.vocab_size == -1:
        cfg.model.config_args.vocab_size = len(tokeniser.text_tokeniser)
    tlm = tlm_factory(cfg.model, device=device)
    if mesh is not None:
        fsdp = bool(cfg.get("eval_fsdp", False))
        tlm.shard(mesh, fsdp=fsdp)
        logger.info("eval sharded over a %d-rank data mesh%s", mesh.size,
                    " (weights sharded: fsdp)" if fsdp else "")
    vocoder = vocoder_factory(cfg.vocoder, device=device)
    model = SpeechLM(tlm, tokeniser, vocoder=vocoder)

    path = resolve_reference_path(cfg.metric.data_path, cfg.get("reference_path", None))
    used_token_modality = cfg.metric.get("used_token_modality", None)
    mean_nll = cfg.metric.get("mean_nll", True)
    gen_kwargs = to_container(cfg.metric.get("generate_kwargs", None)) or {}

    # joint_pairs scores (pos, neg) in one [2B] call (metric.joint_pairs)
    jp = bool(cfg.metric.get("joint_pairs", False))
    if cross_modal:
        from ..metric.cross_modal_generation import generate as cm_generate
        from ..metric.cross_modal_metric import cm_storycloze

        if mt == "storycloze":
            res = cm_storycloze(model, path, cfg.metric.prompt_modality,
                                cfg.metric.cont_modality, used_token_modality, mean_nll,
                                cfg.batch_size, cfg.num_workers, cfg.pin_memory,
                                cfg.metric.get("subfolder", False))
        elif mt == "generate":
            res = cm_generate(model, path, cfg.batch_size, cfg.metric.prompt_modality,
                              cfg.metric.get("cont_modality", None), cfg.metric.prompt_length,
                              tokeniser.fe_sample_rate, cfg.metric.num_files,
                              cfg.num_workers, cfg.pin_memory, **gen_kwargs)
        else:
            raise ValueError(f"Unknown cross-modal metric: {mt}")
    elif mt == "swuggy":
        res = swuggy(model, path, used_token_modality, mean_nll, cfg.batch_size,
                     cfg.num_workers, cfg.pin_memory, cfg.metric.get("subfolder", False),
                     joint_pairs=jp)
    elif mt == "sblimp":
        res = sblimp(model, path, used_token_modality, mean_nll, cfg.batch_size,
                     cfg.num_workers, cfg.pin_memory, cfg.metric.get("subfolder", False),
                     joint_pairs=jp)
    elif mt == "storycloze":
        res = storycloze(model, path, used_token_modality, mean_nll, cfg.batch_size,
                         cfg.num_workers, cfg.pin_memory, cfg.metric.get("subfolder", False),
                         joint_pairs=jp)
    elif mt == "salmon":
        res = salmon(model, path, used_token_modality, mean_nll, cfg.metric.parts,
                     cfg.batch_size, cfg.num_workers, cfg.pin_memory, joint_pairs=jp)
    elif mt == "generate":
        if cfg.vocoder.vocoder_type is None:
            logger.warning("Running generation without a vocoder generates "
                           "tokens only; set e.g. vocoder=vocoder_hubert_25")
        res = generate(model, path, cfg.batch_size, used_token_modality,
                       cfg.metric.prompt_length, cfg.metric.get("min_file_length", None),
                       cfg.metric.get("alignment_folder", None),
                       cfg.metric.get("use_alignment", False),
                       tokeniser.fe_sample_rate, cfg.metric.num_files,
                       cfg.num_workers, cfg.pin_memory, **gen_kwargs)
    elif mt == "asr_perplexity":
        res = asr_perplexity(model, path, cfg.batch_size, cfg.metric.whisper_model,
                             cfg.metric.llm_name_or_path, used_token_modality,
                             cfg.metric.prompt_length, cfg.metric.get("min_file_length", None),
                             cfg.metric.get("alignment_folder", None),
                             cfg.metric.get("use_alignment", False),
                             cfg.metric.auto_bleu_n, tokeniser.fe_sample_rate,
                             cfg.metric.get("num_files", None), cfg.num_workers, cfg.pin_memory,
                             cfg.metric.get("torch_device", None) or device,
                             asr_backend=cfg.metric.get("asr_backend", "torch"),
                             asr_dtype=cfg.metric.get("asr_dtype", "float32"),
                             llm_backend=cfg.metric.get("llm_backend", "torch"), **gen_kwargs)
    elif mt == "llm_as_judge":
        res = llm_as_judge(model, path, cfg.batch_size, cfg.metric.whisper_model,
                           cfg.metric.llm_name_or_path, cfg.metric.instruction,
                           used_token_modality, cfg.metric.prompt_length,
                           cfg.metric.min_file_length, cfg.metric.get("alignment_folder", None),
                           cfg.metric.get("use_alignment", False), tokeniser.fe_sample_rate,
                           cfg.metric.get("num_files", None), cfg.num_workers, cfg.pin_memory,
                           cfg.metric.get("torch_device", None) or device,
                           asr_backend=cfg.metric.get("asr_backend", "torch"),
                           asr_dtype=cfg.metric.get("asr_dtype", "float32"),
                           llm_backend=cfg.metric.get("llm_backend", "torch"), **gen_kwargs)
    else:
        raise ValueError(f"Unknown metric type: {mt}")

    if mt != "generate" and lead:
        for key, val in res.items():
            if key in ("generate", "prompts"):
                continue
            if isinstance(val, list):
                print(f"{key}:")
                for i, v in enumerate(val):
                    print(f"\t{i}: {v}")
            else:
                print(f"{key}: {val}")

    if lead and cfg.metric.get("out_path", False) and "generate" in res and \
            cfg.vocoder.vocoder_type is not None:
        from ..utils.audio import save_wav

        os.makedirs(cfg.metric.out_path, exist_ok=True)
        for i, gen in enumerate(res["generate"]):
            if i == cfg.metric.get("num_log", -1):
                print(f"Only saving first {i} samples")
                break
            stem = os.path.join(cfg.metric.out_path, f"{mt}_{i}")
            if isinstance(gen, str):
                with open(stem + ".txt", "w") as f:
                    f.write(gen)
            elif np.size(gen):
                save_wav(f"{stem}.{cfg.metric.ext}", np.asarray(gen).ravel(),
                         tokeniser.fe_sample_rate)

    if lead and cfg.logger.report_to == "wandb":
        import wandb

        if cfg.logger.run_id is None:
            raise ValueError("No run_id specified for wandb logging")
        wandb.init(project=cfg.logger.project, entity=cfg.logger.entity,
                   id=cfg.logger.run_id, resume="must")
        metric_name = f"{mt}/{os.path.basename(os.path.normpath(cfg.metric.data_path))}"
        wandb.log({f"{metric_name}-{part}": val for part, val in res.items()
                   if part not in ("generate", "prompts")})
    return res


if __name__ == "__main__":
    eval_main()
