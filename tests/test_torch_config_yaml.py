"""PyTorch port: the YAML reader and ``Config.from_yaml`` against PyYAML and
the JAX package.

* Each of the repo's ``configs/*.yaml`` loads to the same dict as
  ``yaml.safe_load`` and to the same ``Config.to_dict()`` as the JAX
  package's ``Config.from_yaml``.
* Scalars resolve as YAML 1.1 does (``1e-6`` is a string, ``4.0e-7`` a
  float, ``yes``/``on`` true, ``0x10`` 16), for each case against
  ``yaml.safe_load``.
* Input outside the subset raises with its line number; a scalar where a
  section is expected raises "must be a mapping"; a missing file gives
  ``Config()``.
* ``save_yaml`` writes what the reader, and PyYAML, read back to the same
  dict.
"""
import math
from pathlib import Path

import pytest

from sdxl_training_improvements_tpu import config as JC
from sdxl_training_improvements_tpu_torch import _yaml
from sdxl_training_improvements_tpu_torch import config as TC

yaml = pytest.importorskip("yaml")

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.yaml"))


def test_six_configs_are_found():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_file_matches_pyyaml_and_jax(path):
    assert _yaml.load_file(path) == yaml.safe_load(path.read_text())
    assert TC.Config.from_yaml(path).to_dict() == \
        JC.Config.from_yaml(str(path)).to_dict()


SCALARS = ["1e-6", "4.0e-7", "1.0E+3", "1.0e5", "yes", "No", "on", "OFF",
           "true", "0x10", "-0x1f", "010", "0b101", "1_000", "1:30",
           "1:30.5", "~", "null", "", ".5", "-.5", "3.", ".inf", "-.Inf",
           ".NaN", "+1", "-0", "0o10", "plain text", "'quoted # not a "
           "comment'", '"esc\\t\\u00e9\\x41"', "'it''s'", "[1, 2.5, x]",
           "[[512, 512], [640, 1536]]", "[]", "a'b", "value # comment"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_pyyaml(text):
    ours = _yaml.load(f"k: {text}")["k"]
    ref = yaml.safe_load(f"k: {text}")["k"]
    if isinstance(ref, float) and math.isnan(ref):
        assert isinstance(ours, float) and math.isnan(ours)
    else:
        assert ours == ref and type(ours) is type(ref)


def test_block_lists_nesting_and_comments_match_pyyaml():
    text = """# leading comment
top:
  list:
    - "/data/a"   # trailing
    - b
  same_indent:
  - 1
  - 2.0
  nested:
    deeper:
      x: [1, [2, 3]]
  empty:
other: ~
"""
    assert _yaml.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,where", [
    ("a: &x 1", "line 1"), ("a: *x", "line 1"), ("a: !!str 1", "line 1"),
    ("a: |\n  x", "line 1"), ("a: {b: 1}", "line 1"),
    ("a:\n  - b: 1", "line 2"), ("a: 1\na: 2", "line 2"),
    ("a:\n\tb: 1", "line 2"), ("a: 2001-12-14", "line 1"),
    ("a: b: c", "line 1"), ("a: [1,\n 2]", "line 1"),
    ("a: 'x\n  y'", "line 1"), ("a: 1\n  b: 2", "line 2"),
    ("---\na: 1", "line 1")])
def test_outside_the_subset_raises_with_its_line(text, where):
    with pytest.raises(_yaml.YAMLSubsetError, match=where):
        _yaml.load(text)


def test_malformed_sections_raise(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("model: 5\n")
    with pytest.raises(ValueError, match="must be a mapping"):
        TC.Config.from_yaml(bad)
    bad.write_text("- a\n- b\n")
    with pytest.raises(ValueError, match="must be a mapping"):
        TC.Config.from_yaml(bad)
    assert TC.Config.from_yaml(tmp_path / "missing.yaml") == TC.Config()


def test_save_yaml_round_trips(tmp_path):
    cfg = TC.Config.from_yaml(CONFIGS[0])
    cfg.data.validation_prompts = ["a 'quoted' prompt", "on", "1e-6", ""]
    cfg.optimizer.learning_rate = 4e-7
    cfg.model.min_snr_gamma = None
    cfg.global_config.cache.cache_dir = Path("/tmp/x")
    path = tmp_path / "out.yaml"
    cfg.save_yaml(path)
    expect = dict(cfg.to_dict())
    expect["global_config"]["cache"]["cache_dir"] = "/tmp/x"
    assert _yaml.load_file(path) == expect
    assert yaml.safe_load(path.read_text()) == expect
    assert TC.Config.from_yaml(path).to_dict() == expect


def test_sections_and_defaults_are_jax():
    ours, theirs = TC.Config().to_dict(), JC.Config().to_dict()
    assert ours == theirs
    assert TC.CacheConfig(cache_latents=False).persistent is False
    assert TC.CacheConfig().persistent is True
