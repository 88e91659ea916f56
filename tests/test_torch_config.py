"""The port's config composer (`slamkit_tpu_torch/config`) against the JAX
package's: its YAML reader equals PyYAML with the JAX composer's loader on
every file under `config/` and on the override values; the composition of
each top-level config, with and without overrides, equals the JAX
composer's; the decorator's `-cn`, `-cp` and `-m`; what lies outside the
reader's subset raises with the file and the line; and the cases of
`tests/test_config.py`, repeated against the copy.

Equality is exact and typed (1 is not 1.0 is not True): the values are the
same Python objects' reprs.
"""
import glob
import pathlib
import sys

import pytest

from slamkit_tpu.config import compose as jax_compose
from slamkit_tpu.config.compose import _parse_value as jax_parse_value
from slamkit_tpu.config.compose import _yaml_load as jax_yaml_load
from slamkit_tpu_torch.config import ConfigNode, MissingMandatoryValue, compose, main
from slamkit_tpu_torch.config import yaml_subset
from slamkit_tpu_torch.config.node import ConfigNode as NodeCopy

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG_DIR = str(REPO_ROOT / "config")
YAML_FILES = sorted(str(pathlib.Path(p).relative_to(REPO_ROOT))
                    for p in glob.glob(f"{CONFIG_DIR}/**/*.yaml", recursive=True))
TOP_LEVEL = sorted(pathlib.Path(p).stem for p in glob.glob(f"{CONFIG_DIR}/*.yaml"))
# train_path / val_path are mandatory (???) in the data group
DATA = ["data.train_path=/x.jsonl", "data.val_path=/x.jsonl"]
OVERRIDES = {
    "none": [],
    "model_slam": ["model=slam"],
    "learning_rate": ["training_args.learning_rate=3e-4"],
    "append": ["+x=1"],
    "delete": ["~run_time"],
    "mesh_shape": ["training_args.mesh_shape=[4,2]"],
    "all": ["model=slam", "training_args.learning_rate=3e-4", "+x=1", "~run_time",
            "training_args.mesh_shape=[4,2]", *DATA],
}


def _typed(value):
    """A value with every scalar tagged by its type, for exact comparison."""
    if isinstance(value, dict):
        return {k: _typed(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_typed(v) for v in value]
    return (type(value).__name__, repr(value))


def test_seven_top_level_configs():
    assert TOP_LEVEL == ["eval", "extract_features", "preference_alignment_feature_extractor",
                         "preference_alignment_train", "prepare_tokens", "train",
                         "train_inter_scale"]


@pytest.mark.parametrize("path", YAML_FILES)
def test_reader_equals_pyyaml(path):
    text = (REPO_ROOT / path).read_text()
    assert _typed(yaml_subset.load(text, path)) == _typed(jax_yaml_load(text))


@pytest.mark.parametrize("text", [
    "1e-3", "'1e-3'", '"2e10"', "1.0e+3", ".5", "-.inf", "[4,2]", "['all']", "[data,seq]",
    "{'min_lr': 5e-5}", "{a: [1, 2], b: {c: null}}", "[/a.jsonl,/b.jsonl]", "/a/b.jsonl",
    "null", "~", "", "true", "yes", "Off", "3", "-7", "0x1f", "010", "1_000", "2:30", "0.5",
    "Qwen/Qwen2.5-0.5B", "x=y", "a: b", "foo bar", "it's", "'it''s'", '"q\\"x\\n\\\\"',
    "http://x.y/z", "[a, [b, c]]", "- a", "???", "a #b", "a# b", "[1, 2", "{a", "'open",
])
def test_override_values_equal_pyyaml(text):
    assert _typed(yaml_subset.parse_value(text)) == _typed(jax_parse_value(text))


@pytest.mark.parametrize("text,what", [
    ("a: &x 1\nb: *x\n", "anchors"),
    ("a: !!str 5\n", "tags"),
    ("a: |\n  line\n", "block scalars"),
    ("a: 1\n---\nb: 2\n", "document markers"),
    ("? [a]\n: 1\n", "complex mapping keys"),
    ("a: 2001-12-14\n", "timestamp"),
    ("a: 'two\n  lines'\n", "quoted scalar must end"),
])
def test_outside_the_subset_raises_with_file_and_line(text, what):
    with pytest.raises(yaml_subset.YamlError, match=f"cfg.yaml:[0-9]+: .*{what}"):
        yaml_subset.load(text, "cfg.yaml")


@pytest.mark.parametrize("overrides", list(OVERRIDES.values()), ids=list(OVERRIDES))
@pytest.mark.parametrize("name", TOP_LEVEL)
def test_compose_equals_jax(name, overrides):
    def run(fn, resolve):
        try:
            return _typed(fn(CONFIG_DIR, name, list(overrides)).to_container(resolve=resolve))
        except Exception as e:          # both must fail alike
            return ("raised", type(e).__name__)

    for resolve in (False, True):
        assert run(compose, resolve) == run(jax_compose, resolve)


def test_main_reads_the_repo_config_and_takes_cn_and_cp(tmp_path):
    """The port's CLIs live two levels down (`slamkit_tpu_torch/cli/`); their
    `../../config` is the repo's tree. -cn / --config-name picks another
    top-level config, -cp / --config-path another directory."""
    captured = []
    fake = type(sys)("_torch_fake_cli")
    fake.__file__ = str(REPO_ROOT / "slamkit_tpu_torch" / "cli" / "train.py")
    sys.modules["_torch_fake_cli"] = fake

    def fn(cfg):
        captured.append(cfg)
    fn.__module__ = "_torch_fake_cli"
    wrapped = main(config_name="train", config_path="../../config")(fn)
    wrapped(DATA)
    assert captured[-1].to_container() == jax_compose(CONFIG_DIR, "train", DATA).to_container()
    wrapped(["-cn", "eval", "metric=sblimp"])
    assert captured[-1].to_container() == jax_compose(CONFIG_DIR, "eval",
                                                      ["metric=sblimp"]).to_container()
    wrapped(["--config-name=train_inter_scale", "data.train_path=[/x]", "data.val_path=[/x]"])
    assert captured[-1].model.context_len == 2048
    (tmp_path / "mine.yaml").write_text("a: 1e-3\nb: '1e-3'\n")
    wrapped(["-cp", str(tmp_path), "-cn", "mine"])
    assert captured[-1].to_container() == {"a": 1e-3, "b": "1e-3"}


def test_multirun_sweep_equals_jax():
    """-m fans comma sweeps out into their cartesian product, in the JAX
    composer's order; commas inside brackets are list literals."""
    from slamkit_tpu.config import main as jax_main

    ov = ["-m", "model.context_len=64,128", "training_args.max_steps=1,2",
          "training_args.mesh_shape=[4,2]", *DATA]
    jobs = main("train", str(REPO_ROOT / "config"))(lambda c: c.to_container())(ov)
    ref = jax_main("train", str(REPO_ROOT / "config"))(lambda c: c.to_container())(ov)
    assert len(jobs) == 4 and jobs == ref
    assert sorted((j["model"]["context_len"], j["training_args"]["max_steps"])
                  for j in jobs) == [(64, 1), (64, 2), (128, 1), (128, 2)]
    assert all(j["training_args"]["mesh_shape"] == [4, 2] for j in jobs)


# --------------------------------------------------------------------------- #
# the cases of tests/test_config.py, against the copy
# --------------------------------------------------------------------------- #
def test_compose_train_defaults():
    cfg = compose(CONFIG_DIR, "train")
    assert cfg.model.tlm_type == "twist"
    assert cfg.model.config_args.twist_init is True
    assert cfg.model.context_len == 512
    assert cfg.model.config_args.base_model_name == "facebook/opt-125m"
    assert cfg.training_args.learning_rate == 1e-3
    assert cfg.training_args.lr_scheduler_kwargs.min_lr == 5e-5
    assert cfg.training_args.max_grad_norm == 0.5
    assert cfg.data.packing is False
    assert cfg.tokeniser.tokeniser_type == "unit"
    assert cfg.tokeniser.params.load_fe is False
    assert cfg.cont_training is False
    assert cfg.run_time is None


@pytest.mark.parametrize("overrides,checks", [
    ([], {"tokeniser.feature_extractor.pretrained_model": "slprl/mhubert-base-25hz",
          "tokeniser.feature_extractor.layer": 11}),
    (["model=slam"], {"model.context_len": 1024, "model.tlm_type": "twist",
                      "model.config_args.base_model_name": "Qwen/Qwen2.5-0.5B",
                      "model.config_args.rope_theta": 10000,
                      "model.config_args.torch_dtype": "bfloat16",
                      "model.config_args.twist_init": True}),
    (["tokeniser=unit_hubert_l9"], {"tokeniser.feature_extractor.layer": 9}),
    (["data.train_path=/tmp/x.jsonl", "training_args.learning_rate=5e-4",
      "training_args.per_device_train_batch_size=16", "+training_args.custom_flag=7",
      "model.config_args.vocab_size=502"],
     {"data.train_path": "/tmp/x.jsonl", "training_args.learning_rate": 5e-4,
      "training_args.per_device_train_batch_size": 16, "training_args.custom_flag": 7,
      "model.config_args.vocab_size": 502}),
    (["model=slam", "data.train_path=unused", "model=slam_dh128"],
     {"model.config_args.head_dim": 128, "model.config_args.num_attention_heads": 7,
      "model.config_args.twist_init": False}),
    (["data.train_path=[/a.jsonl,/b.jsonl]"], {"data.train_path": ["/a.jsonl", "/b.jsonl"]}),
    (["tokeniser.feature_extractor=/my/local/ckpt"],
     {"tokeniser.feature_extractor": "/my/local/ckpt"}),
    (["tokeniser/feature_extractor=hubert_base_l9"],
     {"tokeniser.feature_extractor.pretrained_model": "facebook/hubert-base-ls960"}),
])
def test_train_overrides(overrides, checks):
    cfg = compose(CONFIG_DIR, "train", overrides)
    for path, want in checks.items():
        got = cfg.select(path)
        got = list(got) if hasattr(got, "append") else got
        assert got == want and type(got) is type(want), (path, got)


def test_missing_mandatory_raises():
    cfg = compose(CONFIG_DIR, "train")
    with pytest.raises(MissingMandatoryValue):
        _ = cfg.data.train_path
    assert cfg.data.get("train_path") is None


def test_list_values_of_the_sims_recipe():
    cfg = compose(CONFIG_DIR, "train_inter_scale")
    assert list(cfg.data.train_ratios) == [0.2023584112, 0.5433262899, 0.2543152989]
    assert cfg.data.packing is True
    assert cfg.tokeniser.tokeniser_type == "interleave"
    assert cfg.tokeniser.params.interleave_method == "poisson"
    assert cfg.tokeniser.params.interleave_span == 10
    assert cfg.model.context_len == 2048
    assert cfg.ds_token_size == 11081736716


@pytest.mark.parametrize("metric,checks", [
    ("sblimp", {"metric.metric_type": "sblimp", "metric.data_path": "//reference/sblimp",
                "metric.subfolder": True, "vocoder.vocoder_type": None, "batch_size": 8,
                "device": "tpu"}),
    ("generate", {"metric.generate_kwargs.temperature": 0.8,
                  "metric.generate_kwargs.top_k": 25,
                  "metric.generate_kwargs.max_new_tokens": 150,
                  "metric.generate_kwargs.do_sample": True}),
])
def test_eval_config(metric, checks):
    cfg = compose(CONFIG_DIR, "eval", [f"metric={metric}"])
    for path, want in checks.items():
        assert cfg.select(path) == want, path


def test_to_container_roundtrip_and_delete():
    cfg = compose(CONFIG_DIR, "train", ["data.train_path=x", "data.val_path=y"])
    d = cfg.to_container()
    assert d["training_args"]["learning_rate"] == 1e-3 and d["data"]["train_path"] == "x"
    assert "run_time" not in compose(CONFIG_DIR, "train", ["~run_time"])


def test_node_get_in_interpolation_and_merge():
    cfg = ConfigNode({"a": {"b": 7}, "c": None, "x": "${a.b}", "y": "pre-${a.b}-post",
                      "paths": ["${y}/train"]})
    cfg._set_root(cfg)
    assert cfg.get("missing", 5) == 5 and "a" in cfg and cfg.get("c") is None
    assert cfg.x == 7 and cfg.y == "pre-7-post"
    assert list(cfg.paths) == ["pre-7-post/train"]
    assert cfg.to_container()["paths"] == ["pre-7-post/train"]
    node = NodeCopy({"lr": 0.001})
    node.merge_with({"lr": "???", "new": "???"})
    assert node["lr"] == 0.001
    with pytest.raises(MissingMandatoryValue):
        node["new"]


def test_quoted_sci_notation_stays_string():
    out = yaml_subset.load("a: '1e5'\nb: 1e5\nc: \"2e10\"\n")
    assert out["a"] == "1e5" and isinstance(out["b"], float) and out["c"] == "2e10"
