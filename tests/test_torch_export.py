"""The port's serving artifacts (``elastic_tpu_agent_torch/workloads/
export.py``) against the JAX package's, on the CPU: ``config.json``
byte-equal to JAX's, bit-exact weight round trips, ``export_checkpoint``
over the port's ``TrainCheckpointer`` (params, EMA, int8 byte-equal to
JAX ``quantize_params``), the CLI's exit codes and summary keys, and the
runners' decode mode on an artifact (``--params-dir``) token for token.

The weights' files are the port's own (the JAX ones are orbax): the
framing of a ``TrainCheckpointer`` item, which the JAX package's
``tree_to_bytes`` frames byte for byte for a float tree.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import checkpointing as jck  # noqa: E402
from elastic_tpu_agent.workloads import export as jexport  # noqa: E402
from elastic_tpu_agent.workloads import lora as jlora  # noqa: E402
from elastic_tpu_agent.workloads import quantize as jq  # noqa: E402
from elastic_tpu_agent.workloads import runner as jrunner  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import checkpointing as tck  # noqa: E402
from elastic_tpu_agent_torch.workloads import export as texport  # noqa: E402
from elastic_tpu_agent_torch.workloads import runner as trunner  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    lora_from_jax,
    params_from_jax,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48)
CONFIGS = {
    "dense-bf16": dict(dtype="bfloat16"),
    "dense-f32": dict(dtype="float32"),
    "gqa-rope": dict(dtype="bfloat16", pos="rope", n_kv_heads=2,
                     rope_theta=5e5),
    "window": dict(dtype="float32", window=16, attn="reference", remat=True),
    "moe": dict(dtype="bfloat16", moe_experts=4, moe_every=1,
                moe_capacity_factor=2.0),
}
RUNNER_ENV = ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR", "TPU_WORKER_HOSTNAMES",
              "ELASTIC_TPU_HBM_FRACTION", "TPU_MEM_FRACTION",
              "ELASTIC_TPU_FLIGHT_RECORDER", "ELASTIC_TPU_RESTORE_DIR",
              "ELASTIC_TPU_RESTORE_STEP")


def _cfgs(kw):
    kw = dict(kw)
    name = kw.pop("dtype")
    return (jt.ModelConfig(**BASE, **kw, dtype=getattr(jnp, name)),
            tt.ModelConfig(**BASE, **kw, dtype=getattr(torch, name)))


def _leaves_by_path(tree):
    return {tck._path_name(p): x for p, x in tck._flatten(tree)}


def _assert_same_tree(got, want):
    g, w = _leaves_by_path(got), _leaves_by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_json_is_byte_equal_to_jax(name, tmp_path):
    jcfg, tcfg = _cfgs(CONFIGS[name])
    jexport.save_artifact(str(tmp_path / "j"), {"x": jnp.zeros(2)}, jcfg)
    texport.save_artifact(str(tmp_path / "t"), {"x": torch.zeros(2)}, tcfg)
    want = (tmp_path / "j" / "config.json").read_bytes()
    assert (tmp_path / "t" / "config.json").read_bytes() == want
    _, cfg = texport.load_artifact(str(tmp_path / "t"), device="cpu")
    assert cfg == tcfg


def _float_tree(tcfg, dtype=torch.float32):
    jcfg = jt.ModelConfig(**{k: getattr(tcfg, k) for k in BASE},
                          n_kv_heads=tcfg.n_kv_heads, pos=tcfg.pos,
                          moe_experts=tcfg.moe_experts,
                          moe_every=tcfg.moe_every)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(3)))
    return tree, params_from_jax(tree, tcfg, device="cpu", dtype=dtype)


@pytest.mark.parametrize("form", ["float-bf16", "int8", "lora-merged"])
def test_weights_round_trip_bit_exact(form, tmp_path):
    """Float (bf16, the MoE router f32), int8 {"q","s"} and merged-LoRA
    trees come back leaf for leaf, dtype and bits; a float tree's payload
    is the JAX tree_to_bytes framing of the same tree."""
    _, tcfg = _cfgs(CONFIGS["moe"] if form == "float-bf16"
                    else CONFIGS["dense-f32"])
    tree, params = _float_tree(tcfg, torch.float32)
    if form == "float-bf16":
        params = params_from_jax(tree, tcfg, device="cpu")
    elif form == "int8":
        from elastic_tpu_agent_torch.workloads.quantize import quantize_params

        params = quantize_params(params)
    else:
        from elastic_tpu_agent_torch.workloads.lora import merge_lora

        ad = jax.device_get(jlora.init_lora_params(
            tree, jax.random.key(4), rank=4))
        ad = jax.tree_util.tree_map(lambda x: x + 0.01, ad)
        params = merge_lora(params, lora_from_jax(ad, tcfg, device="cpu"))
    texport.save_artifact(str(tmp_path), params, tcfg)
    got, cfg = texport.load_artifact(str(tmp_path), device="cpu")
    assert cfg == tcfg
    _assert_same_tree(got, params)
    if form == "float-bf16":
        data = (tmp_path / "weights" / "data.bin").read_bytes()
        jtree = jax.tree_util.tree_map(
            lambda x: np.asarray(x).astype(jnp.bfloat16), tree)
        for layer, src in zip(jtree["layers"], tree["layers"]):
            layer["moe"]["wg"] = np.asarray(src["moe"]["wg"], np.float32)
        assert data == bytes(jck.tree_to_bytes(jtree))


@pytest.fixture
def port_checkpoint(tmp_path):
    """A port TrainCheckpointer step 7 of the f32 dense config, with an
    EMA item, from the JAX init's weights; returns (dir, tree, ema)."""
    _, tcfg = _cfgs(CONFIGS["dense-f32"])
    tree, params = _float_tree(tcfg)
    ema = tt._like(params, [x * 0.5 for x in tt._leaves(params)])
    ck = tck.TrainCheckpointer(str(tmp_path / "ck"))
    ck.save(7, params, {"count": torch.zeros((), dtype=torch.int32)}, ema=ema)
    ck.close()
    return str(tmp_path / "ck"), tree, params, ema


@pytest.mark.parametrize("kind", ["params", "ema", "int8"])
def test_export_checkpoint(port_checkpoint, tmp_path, kind):
    """export_checkpoint over the port's TrainCheckpointer: the params or
    the EMA item, or params quantized to an int8 tree byte-equal to JAX
    quantize_params on the same weights; the summary's keys and bytes are
    JAX's."""
    ck, tree, params, ema = port_checkpoint
    _, tcfg = _cfgs(CONFIGS["dense-f32"])
    out = str(tmp_path / "art")
    summary = texport.export_checkpoint(
        ck, out, tcfg, int8=kind == "int8", ema=kind == "ema", device="cpu")
    assert set(summary) == {"step", "int8", "ema", "bytes", "out"}
    assert summary["step"] == 7 and summary["out"] == os.path.abspath(out)
    got, _ = texport.load_artifact(out, device="cpu")
    if kind == "int8":
        want = jq.quantize_params(tree)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            mine = _leaves_by_path(got)[key]
            assert np.asarray(leaf).tobytes() == mine.numpy().tobytes(), key
        assert summary["bytes"] == sum(
            x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(want))
    else:
        _assert_same_tree(got, ema if kind == "ema" else params)
        assert summary["bytes"] == 4 * sum(
            x.size for x in jax.tree_util.tree_leaves(tree))


def test_export_of_an_empty_directory_raises(tmp_path):
    _, tcfg = _cfgs(CONFIGS["dense-f32"])
    with pytest.raises(FileNotFoundError, match="holds no checkpoint"):
        texport.export_checkpoint(str(tmp_path / "none"), str(tmp_path / "o"),
                                  tcfg, device="cpu")


def _cli(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue().strip().splitlines()


def test_cli_exit_codes_and_summary_match_jax(tmp_path):
    """Both CLIs on the tiny preset: the same summary keys (and step,
    int8, ema) for a checkpoint of each package's own format, the same
    SystemExit text for an empty directory, argparse's exit 2 without
    --out."""
    seq = 16
    jcfg = jt.ModelConfig(max_seq=seq, **jrunner.PRESETS["tiny"])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    jck_dir, tck_dir = str(tmp_path / "jck"), str(tmp_path / "tck")
    jc = jck.TrainCheckpointer(jck_dir)
    jc.save(5, tree, {"n": np.zeros(())})
    jc.wait()
    jc.close()
    tcfg = tt.ModelConfig(max_seq=seq, **trunner.PRESETS["tiny"])
    tc = tck.TrainCheckpointer(tck_dir)
    tc.save(5, params_from_jax(tree, tcfg, device="cpu",
                               dtype=torch.float32),
            {"count": torch.zeros((), dtype=torch.int32)})
    tc.close()
    argv = ["--preset", "tiny", "--seq", str(seq), "--int8"]
    rc_j, out_j = _cli(jexport.main, argv + ["--checkpoint-dir", jck_dir,
                                              "--out", str(tmp_path / "ja")])
    rc_t, out_t = _cli(texport.main, argv + ["--checkpoint-dir", tck_dir,
                                              "--out", str(tmp_path / "ta")],
                       device="cpu")
    j, t = json.loads(out_j[-1]), json.loads(out_t[-1])
    assert rc_j == rc_t == 0
    assert set(j) == set(t)
    assert [j[k] for k in ("step", "int8", "ema", "bytes")] == [
        t[k] for k in ("step", "int8", "ema", "bytes")]
    empty = str(tmp_path / "empty")
    msgs = []
    for main, kw in ((jexport.main, {}), (texport.main, {"device": "cpu"})):
        with pytest.raises(SystemExit) as e:
            main(["--checkpoint-dir", empty, "--out", str(tmp_path / "x")],
                 **kw)
        msgs.append(str(e.value))
        with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(
                io.StringIO()):
            main(["--checkpoint-dir", empty], **kw)
        assert e.value.code == 2
    assert msgs[0] == msgs[1] == f"{empty} holds no checkpoint to export"


@pytest.fixture
def runner_env(monkeypatch, tmp_path):
    for name in RUNNER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ELASTIC_TPU_ENV_FILE", str(tmp_path / "no-env"))
    monkeypatch.setenv("ELASTIC_TPU_RESTORE_WAIT_S", "0")


def _artifacts(tmp_path, **kw):
    """A JAX artifact and a port artifact of the same f32 weights (the
    tiny preset's widths, 2 layers)."""
    cfg = dict(jrunner.PRESETS["tiny"], max_seq=32, **kw)
    jcfg = jt.ModelConfig(**cfg, dtype=jnp.float32)
    tcfg = tt.ModelConfig(**cfg, dtype=torch.float32)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(2)))
    jdir, tdir = str(tmp_path / "ja"), str(tmp_path / "ta")
    jexport.save_artifact(jdir, tree, jcfg)
    texport.save_artifact(tdir, params_from_jax(tree, tcfg, device="cpu",
                                                dtype=torch.float32), tcfg)
    return jdir, tdir, jcfg


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_runner_decode_on_an_artifact_matches_jax(runner_env, tmp_path,
                                                  monkeypatch, int8):
    """--mode decode --params-dir in both runners, each on its own
    package's artifact of the same weights, with the JAX runner's prompts
    (a test-only patch of the port's decode_prompt): the same report keys,
    restored_step "artifact", the same greedy tail; --int8 quantizes a
    float artifact in both. The artifact's config (f32) overrides
    --preset."""
    jdir, tdir, jcfg = _artifacts(tmp_path)
    argv = "--mode decode --preset small --batch 4 --prompt-len 8 "
    argv += "--new-tokens 6" + (" --int8" if int8 else "")
    prompt = np.array(jax.random.randint(
        jax.random.key(1), (4, 8), 0, jcfg.vocab))
    monkeypatch.setattr(trunner, "decode_prompt", lambda cfg, b, p: prompt)
    rc_j, out_j = _cli(jrunner.main, (argv + f" --params-dir {jdir}").split())
    rc_t, out_t = _cli(trunner.main, (argv + f" --params-dir {tdir}").split(),
                       device="cpu")
    want, got = json.loads(out_j[-1]), json.loads(out_t[-1])
    assert rc_j == rc_t == 0
    assert set(got) == set(want)
    assert got["restored_step"] == want["restored_step"] == "artifact"
    assert got["int8"] is want["int8"] is int8
    assert got["sample_tail"] == want["sample_tail"]


def test_runner_params_dir_refusals_match_jax(runner_env, tmp_path):
    """--params-dir with --checkpoint-dir, and a decode longer than a
    learned-position artifact's max_seq, exit with JAX's messages."""
    jdir, tdir, _ = _artifacts(tmp_path)
    for argv in ([f"--checkpoint-dir {tmp_path}"],
                 ["--prompt-len 30 --new-tokens 6"]):
        msgs = []
        for main, d, kw in ((jrunner.main, jdir, {}),
                            (trunner.main, tdir, {"device": "cpu"})):
            with pytest.raises(SystemExit) as e:
                main(f"--mode decode --params-dir {d} {argv[0]}".split(),
                     **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert "exclusive" in msgs[0] or "exceeds the trained" in msgs[0]
