"""csm_tpu_torch stands alone: importing it loads no JAX and nothing of
csm_tpu, its config is a faithful copy, and its entry points run on CUDA
unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu_torch.config import CSMConfig, LlamaConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "tiny_golden")

_ISOLATION = r"""
import importlib, pkgutil, sys
import csm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(csm_tpu_torch.__path__, "csm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "csm_tpu") or m.startswith(("jax.", "flax.", "csm_tpu.")))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 12, names
assert {"csm_tpu_torch.serving", "csm_tpu_torch.codec.mimi", "csm_tpu_torch.codec.streaming",
        "csm_tpu_torch.codec.convert", "csm_tpu_torch.parallel", "csm_tpu_torch.parallel.mesh",
        "csm_tpu_torch.parallel.launch", "csm_tpu_torch.parallel.collectives",
        "csm_tpu_torch.data.processor", "csm_tpu_torch.data.dataset",
        "csm_tpu_torch.data.audio_io", "csm_tpu_torch.data.tokenizer", "csm_tpu_torch.native",
        "csm_tpu_torch.train.cli", "csm_tpu_torch.entry", "csm_tpu_torch.utils.profiling",
        "csm_tpu_torch.utils.measure", "csm_tpu_torch.utils.warmup",
        "csm_tpu_torch.examples.generate", "csm_tpu_torch.examples.serve"} <= set(names), names
from csm_tpu_torch.data import CSMAudioTextDataset, CSMDataCollator, CSMProcessor
"""


def test_import_loads_no_jax_and_nothing_of_csm_tpu():
    """In a fresh interpreter (this process already imported JAX through
    conftest): every submodule of the port imports without jax, flax or
    csm_tpu."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", _ISOLATION], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


_ALONE = r"""
import importlib, sys
module = importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "csm_tpu") or m.startswith(("jax.", "flax.", "csm_tpu.")))
assert not bad, bad
for name in sys.argv[2:]:
    assert callable(getattr(module, name)), name
"""


@pytest.mark.parametrize("module,names", [
    ("csm_tpu_torch.entry", ["entry", "dryrun_multichip"]),
    ("csm_tpu_torch.utils.profiling", ["trace", "sync", "FrameTimer", "enable_nan_checks"]),
    ("csm_tpu_torch.utils", ["trace", "FrameTimer", "enable_nan_checks"]),
    ("csm_tpu_torch.utils.measure", ["prefill_ms_on_device", "prefill_flops"]),
    ("csm_tpu_torch.utils.warmup", ["warmup_generation"]),
    ("csm_tpu_torch.ops.attention", ["set_attention_impl", "flash_eligible",
                                     "sp_flash_eligible"]),
    ("csm_tpu_torch.examples.generate", ["main"]),
    ("csm_tpu_torch.examples.serve", ["main"]),
])
def test_new_modules_import_alone_without_jax(module, names):
    """Each module of the last slice, imported first in a fresh interpreter,
    loads no jax, flax or csm_tpu and has the JAX counterpart's public
    names."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _ALONE, module, *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_EXPORTS = r"""
import sys
import csm_tpu_torch
from csm_tpu_torch import CSMServer, CSMStreamer, __version__
from csm_tpu_torch.serving import CSMServer as S, CSMStreamer as St
assert CSMServer is S and CSMStreamer is St, (CSMServer, CSMStreamer)
assert isinstance(__version__, str) and __version__, __version__
assert set(csm_tpu_torch.__all__) >= {"CSMModel", "CSMServer", "CSMStreamer", "__version__"}
try:
    csm_tpu_torch.NoSuchName
except AttributeError:
    pass
else:
    raise AssertionError("an unknown attribute resolved")
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "csm_tpu") or m.startswith(("jax.", "flax.", "csm_tpu.")))
assert not bad, bad
print(__version__)
"""


def test_top_level_exports_resolve_without_jax():
    """In a fresh interpreter: ``CSMServer``, ``CSMStreamer`` and
    ``__version__`` resolve on the package, as on ``csm_tpu``, and resolving
    them loads no jax, flax or csm_tpu module."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", _EXPORTS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_version_matches_the_jax_package():
    import csm_tpu
    import csm_tpu_torch

    assert csm_tpu_torch.__version__ == csm_tpu.__version__
    for name in ("CSMServer", "CSMStreamer", "__version__"):
        assert hasattr(csm_tpu_torch, name) and hasattr(csm_tpu, name), name


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from csm_tpu_torch import CSMModel
    from csm_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CSMModel(CSMConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CSMModel.from_pretrained(FIXDIR)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert CSMModel(CSMConfig.tiny(), device="cpu").device.type == "cpu"


def test_kernel_wrappers_reject_other_devices():
    """A wrapper takes its plain version only for CPU tensors; anything that
    is neither CPU nor CUDA raises rather than falling back."""
    from csm_tpu_torch.ops.flash_attention import flash_attention

    q = torch.empty((1, 8, 4, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 8, 1, 64), device="meta", dtype=torch.bfloat16)
    valid = torch.ones((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, k, k, valid)


@pytest.mark.parametrize("size", ["csm-1b", "tiny"])
def test_config_is_a_faithful_copy(size, tmp_path):
    cfg = CSMConfig.tiny() if size == "tiny" else CSMConfig()
    jcfg = JaxCSMConfig.tiny() if size == "tiny" else JaxCSMConfig()
    assert cfg.to_dict() == jcfg.to_dict()
    path = str(tmp_path / "config.json")
    cfg.to_json(path)
    assert CSMConfig.from_json(path) == cfg
    assert cfg.decoder_rope_positions == 33
    # forced overrides
    assert cfg.backbone.vocab_size == cfg.text_vocab_size
    assert cfg.backbone.max_position_embeddings == cfg.max_seq_len
    assert cfg.decoder.max_position_embeddings == cfg.audio_num_codebooks


def test_config_reads_hf_rope_type_key():
    d = CSMConfig().to_dict()
    d["backbone_config"]["rope_scaling"] = {"type": "llama3", "factor": 8.0}
    cfg = CSMConfig.from_dict(d)
    assert cfg.backbone.rope_scaling.rope_type == "llama3"
    assert cfg.backbone.rope_scaling.factor == 8.0
    assert isinstance(cfg.decoder, LlamaConfig)


def test_unported_tiers_raise():
    """Every tier is ported; a ``bits`` outside {4, 8, 16} raises as the JAX
    package's ``prepare_streamed_backbone`` does."""
    from csm_tpu_torch import CSMModel
    from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone

    model = CSMModel(CSMConfig.tiny(), device="cpu")
    for bits in (2, 6, 32):
        with pytest.raises(ValueError, match="bits must be 4, 8, or 16"):
            model.quantize(bits=bits)
        with pytest.raises(ValueError, match="bits must be 4, 8, or 16"):
            prepare_streamed_backbone(model.params, model.config, bits=bits)
    assert model._qsb is None
