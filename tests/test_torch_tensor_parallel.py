"""Tensor parallelism over the model axis in the port (parallel/mesh.py's
data x model grid, parallel/sharding_rules.py, the sharded train state of
both trainers, `--model-parallel`) against one process and against the JAX
package's TP step, float32 on the CPU with gloo.

The configs are tests/test_tensor_parallel.py's TINY_ACOUSTIC and TINY_VOC
(the vocoder in adv_mel_fm) with every dropout at 0 (the two packages draw
different masks); its batches (B = 4: Tph 6, 16 frames; mel 8 frames).
The parent process builds the JAX states and writes the port's initial
state dicts and the global batches into two plans (`multiprocess_dp`),
one launched on 2 ranks (data 1 x model 2) and one on 4 (data 2 x model
2); the ranks load them and import no JAX.

Bounds:
* data 1 x model 2 against the single-process control: every metric of
  every step and the gathered parameters (and spectral u, v) after the
  last step bit-equal: the ranks see the same rows and gather the same
  whole weights, and clipping, AdamW, accumulation and the EMA are
  elementwise on the slices.  No op departs by a last bit here.
* against JAX's TP step (`shard_tree` on `create_mesh(data=2, model=2)`),
  both launches: the tolerances of tests/test_tensor_parallel.py, step 1
  then step 2 (acoustic total_loss rtol 2e-4 / 1e-3, grad_norm 2e-3 /
  5e-3; vocoder gen/disc/mel/fm losses 3e-4 / 2e-3); data 2 x model 2
  against the control, the same.
* per-rank persistent state (parameters, both Adam moments, EMA) exactly
  (replicated) + (sharded) / 2 elements; the whole leaves bit-equal on
  every rank, each slice bit-equal across the data groups.
* the shape rule selects exactly the leaves the JAX rule shards (mapped
  through the flax -> port converters of `weights.py`), along the mapped
  dimension.
The command lines: `--model-parallel 2` under torchrun writes the model = 1
checkpoint format, bit-equal to one process's, and checkpoints resume
across model sizes and load into the pipeline.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401
import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sambert_hifigan_tpu.models.acoustic_model import SAMBERTAcousticModel as JAcoustic
from sambert_hifigan_tpu.models.hifigan import HiFiGAN as JHiFiGAN
from sambert_hifigan_tpu.parallel.mesh import create_mesh
from sambert_hifigan_tpu.parallel.mesh import shard_batch as j_shard_batch
from sambert_hifigan_tpu.parallel.sharding_rules import shard_tree, tp_sharding_for_leaf
from sambert_hifigan_tpu.training.acoustic_trainer import (
    make_acoustic_optimizer,
    make_jitted_acoustic_step,
)
from sambert_hifigan_tpu.training.train_state import AcousticTrainState as JAcState
from sambert_hifigan_tpu.training.train_state import VocoderTrainState as JVocState
from sambert_hifigan_tpu.training.vocoder_trainer import (
    make_jitted_vocoder_step,
    make_vocoder_optimizers,
)

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch import multiprocess_dp as mp
from sambert_hifigan_tpu_torch import train_acoustic, train_vocoder
from sambert_hifigan_tpu_torch.models.acoustic_model import SAMBERTAcousticModel
from sambert_hifigan_tpu_torch.models.hifigan import HiFiGAN
from sambert_hifigan_tpu_torch.parallel import mesh
from sambert_hifigan_tpu_torch.parallel.sharding_rules import param_dims
from sambert_hifigan_tpu_torch.training.checkpoint import CheckpointManager
from sambert_hifigan_tpu_torch.weights import (
    acoustic_state_dict_from_flax,
    vocoder_state_dicts_from_flax,
)
from tests.test_tensor_parallel import TINY_ACOUSTIC, TINY_VOC, _acoustic_batch
from tests.test_tensor_parallel import _cfg as jax_cfg
from tests.test_torch_acoustic_model import _fill as fill_acoustic
from tests.test_torch_discriminators import jax_variables
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240
M = 2  # the model axis
# tests/test_tensor_parallel.py's bounds of JAX's TP step: (step 1, step 2)
AC_RTOL = {"total_loss": (2e-4, 1e-3), "grad_norm": (2e-3, 5e-3)}
VOC_RTOL = {k: (3e-4, 2e-3) for k in ("gen_loss", "disc_loss", "gen_mel_loss", "gen_fm_loss")}


def _no_dropout(am):
    return dataclasses.replace(
        am, dropout=0.0, encoder=dataclasses.replace(am.encoder, dropout=0.0),
        decoder=dataclasses.replace(am.decoder, dropout=0.0),
        variance_adaptor=dataclasses.replace(am.variance_adaptor, predictor_dropout=0.0))


def _port(x):
    """A config dataclass of the JAX package as the port's class of the same
    name (the port's config is a copy of it), recursively."""
    if dataclasses.is_dataclass(x):
        return getattr(pcfg, type(x).__name__)(
            **{f.name: _port(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def configs():
    """(JAX config, port config): TINY_ACOUSTIC without dropout, TINY_VOC in
    adv_mel_fm, both stages in float32."""
    cfg_j = jax_cfg()
    cfg_j = dataclasses.replace(cfg_j, acoustic_model=_no_dropout(TINY_ACOUSTIC),
                                vocoder=dataclasses.replace(TINY_VOC, loss_mode="adv_mel_fm"))
    return cfg_j, _port(cfg_j)


def jax_acoustic_variables(cfg_j, seed=0):
    model = JAcoustic(cfg_j.acoustic_model)
    ph = jnp.zeros((1, 6), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), ph, ph, ph, jnp.zeros((1, 16, 80)), jnp.ones((1, 6), jnp.int32)))
    return model, {"params": fill_acoustic(dict(shapes["params"]), np.random.default_rng(seed))}


def jax_vocoder_variables(cfg_j, seed=3):
    model = JHiFiGAN(cfg_j.vocoder)
    return model, jax_variables(model, seed, jnp.zeros((1, 80, 8)), method=JHiFiGAN.init_all)


def _acoustic_batches():
    return [{k: np.asarray(v) for k, v in _acoustic_batch(seed=s).items()} for s in (0, 9, 11)]


def _vocoder_pairs():
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((4, 80, 8)).astype(np.float32),
             (rng.standard_normal((4, 1, 8 * 256)) * 0.1).astype(np.float32)) for _ in range(3)]


def _host(metrics):
    return {k: float(v) for k, v in jax.device_get(metrics).items()}


def _jax_acoustic_steps(model, cfg_j, variables, batches, mesh_j):
    params = variables
    state = JAcState(params=params, opt_state=make_acoustic_optimizer(cfg_j).init(params),
                     step=jnp.zeros((), jnp.int32), ema_params=None)
    state = shard_tree(jax.tree.map(jnp.asarray, state), mesh_j)
    step = make_jitted_acoustic_step(model, cfg_j)  # shardings inferred
    out = []
    for batch in batches:
        state, m = step(state, j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                             mesh_j), jax.random.PRNGKey(5))
        out.append(_host(m))
    return out


def _jax_vocoder_steps(model, cfg_j, variables, pairs, mesh_j):
    params = variables["params"]
    g_params = {"params": {"generator": params["generator"]}}
    d_params = {"params": {"msd": params["msd"], "mpd": params["mpd"]}}
    g_opt, d_opt = make_vocoder_optimizers(cfg_j)
    state = JVocState(g_params=g_params, d_params=d_params, g_opt_state=g_opt.init(g_params),
                      d_opt_state=d_opt.init(d_params), step=jnp.zeros((), jnp.int32),
                      g_ema_params=None)
    state = shard_tree(jax.tree.map(jnp.asarray, state), mesh_j)
    step = make_jitted_vocoder_step(model, cfg_j, loss_mode="adv_mel_fm")
    out = []
    for mel, wav in pairs:
        state, m = step(state, *j_shard_batch((jnp.asarray(mel), jnp.asarray(wav)), mesh_j))
        out.append(_host(m))
    return out


def _stage(cfg, name, **kw):
    tr = dataclasses.replace(getattr(cfg.training, name), **kw)
    return dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, **{name: tr}))


def _spectral(cfg):
    disc = dataclasses.replace(cfg.vocoder.discriminator, msd_use_spectral_norm=True,
                               mpd_use_spectral_norm=True)
    return dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder, discriminator=disc))


# the runs of the data 1 x model 2 launch, by name
D1_RUNS = ("acoustic", "acoustic-accumulate-ema", "vocoder", "vocoder-spectral-ema")
D2_RUNS = ("acoustic", "vocoder")


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Both launches (running while this process computes the JAX steps and
    the single-process controls) and their references."""
    cfg_j, cfg_p = configs()
    model_aj, var_a = jax_acoustic_variables(cfg_j)
    model_vj, var_v = jax_vocoder_variables(cfg_j)
    init_a = acoustic_state_dict_from_flax(var_a)
    init_v = vocoder_state_dicts_from_flax(var_v["params"])
    batches, pairs = _acoustic_batches(), _vocoder_pairs()
    common = dict(params=True, model_parallel=M)
    d1 = [mp.make_run("acoustic", cfg_p, 3, 4, init=init_a, batches=batches, **common),
          mp.make_run("acoustic", _stage(cfg_p, "acoustic", accumulate_steps=2, ema_decay=0.9),
                      4, 4, batches=batches + batches[:1], **common),
          mp.make_run("vocoder", cfg_p, 3, 4, init=init_v, batches=pairs,
                      loss_mode="adv_mel_fm", **common),
          mp.make_run("vocoder", _spectral(_stage(cfg_p, "vocoder", ema_decay=0.9)), 3, 4,
                      batches=pairs, loss_mode="adv_mel_fm", seed=2, **common)]
    d2 = [dict(d1[0], steps=2), dict(d1[2], steps=2)]
    mesh_j = create_mesh(data=2, model=M, devices=jax.devices()[:4])
    with ThreadPoolExecutor(2) as pool:
        l1 = pool.submit(mp.launch, d1, 2, "cpu", tmp_path_factory.mktemp("d1"), TIMEOUT)
        l2 = pool.submit(mp.launch, d2, 4, "cpu", tmp_path_factory.mktemp("d2"), TIMEOUT)
        jax_ac = _jax_acoustic_steps(model_aj, cfg_j, var_a, batches[:2], mesh_j)
        jax_voc = _jax_vocoder_steps(model_vj, cfg_j, var_v, pairs[:2], mesh_j)
        threads = torch.get_num_threads()
        torch.set_num_threads(mp.CPU_THREADS)  # the ranks' own: the same reduction splits
        try:
            control = mp.run_plan(d1, "cpu")  # one process: the state whole
        finally:
            torch.set_num_threads(threads)
        ranks1, ranks2 = l1.result(), l2.result()
    return dict(cfg_p=cfg_p, d1=d1, d2=d2, ranks1=ranks1, ranks2=ranks2, control=control,
                jax={"acoustic": jax_ac, "vocoder": jax_voc})


# ---- the shape rule ----------------------------------------------------------------


def _marks(tree, mesh_j):
    """Each leaf: 1 + its index along the last axis where the JAX rule
    shards it, else 0."""
    def mark(path, x):
        spec = tp_sharding_for_leaf(x, mesh_j, path).spec
        if spec == jax.sharding.PartitionSpec():
            return np.zeros(x.shape, np.float32)
        return np.broadcast_to(1 + np.arange(x.shape[-1], dtype=np.float32), x.shape).copy()
    return jax.tree_util.tree_map_with_path(mark, tree)


@pytest.mark.parametrize("model", ["acoustic", "vocoder", "vocoder-spectral"])
def test_rule_shards_the_leaves_the_jax_rule_shards(model):
    """Marks of the JAX rule's sharded dimension, carried through the flax
    -> port converters, land on exactly the port's sharded parameters,
    along the dimension the port's rule names."""
    cfg_j, cfg_p = configs()
    mesh_j = create_mesh(data=4, model=M)
    if model == "acoustic":
        _, variables = jax_acoustic_variables(cfg_j)
        sd = acoustic_state_dict_from_flax(_marks(variables, mesh_j))
        port = SAMBERTAcousticModel(cfg_p.acoustic_model)
    else:
        if model == "vocoder-spectral":
            cfg_j, cfg_p = _spectral(cfg_j), _spectral(cfg_p)
        _, variables = jax_vocoder_variables(cfg_j)
        marked = _marks(variables, mesh_j)
        sd = vocoder_state_dicts_from_flax(marked["params"], marked.get("spectral"))
        port = HiFiGAN(cfg_p.vocoder)
    names = [n for n, _ in port.named_parameters()]
    dims = param_dims([port], M)
    sharded = []
    for name, dim in zip(names, dims):
        got = sd[name].numpy()
        if dim is None:
            assert not got.any(), f"{name}: JAX shards it, the port keeps it whole"
            continue
        sharded.append(name)
        shape = [1] * got.ndim
        shape[dim] = got.shape[dim]
        want = np.broadcast_to((1 + np.arange(got.shape[dim])).reshape(shape), got.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} along dim {dim}")
    assert len(sharded) > 10, sharded
    if model != "acoustic":
        assert not [n for n in sharded if n.startswith("generator.ups.")]
        assert any(n.startswith("generator.ups.") for n in names)
    assert not [b for b in dict(port.named_buffers()) if b in sharded]


def test_set_model_parallel_refuses_one_process_and_zero():
    with pytest.raises(ValueError, match="this is one process"):
        mesh.set_model_parallel(2)
    with pytest.raises(ValueError, match=">= 1"):
        mesh.set_model_parallel(0)
    mesh.set_model_parallel(1)
    assert (mesh.model_size(), mesh.data_size(), mesh.data_index()) == (1, 1, 0)


def test_train_acoustic_refuses_model_parallel_in_one_process(tmp_path):
    with pytest.raises(ValueError, match="--model-parallel 2 needs a process group"):
        train_acoustic.main(["--synthetic", "1", "--device", "cpu", "--model-parallel", "2",
                             "--checkpoint-dir", str(tmp_path / "ck"),
                             "--log-dir", str(tmp_path / "logs")])


# ---- the launches --------------------------------------------------------------------


@pytest.mark.parametrize("name", D1_RUNS)
def test_data1_matches_one_process_bit_for_bit(tp, name):
    """data 1 x model 2: every metric of every step, and the gathered
    parameters and buffers after the last, bit-equal to the control's on
    both ranks."""
    i = D1_RUNS.index(name)
    control = tp["control"][i]
    for r, res in enumerate(r[i] for r in tp["ranks1"]):
        assert res["model_parallel"] == M and len(res["history"]) == tp["d1"][i]["steps"]
        assert res["history"] == control["history"], (r, res["history"], control["history"])
        assert sorted(res["params"]) == sorted(control["params"])
        for k, v in control["params"].items():
            assert torch.equal(res["params"][k], v), (r, k)


@pytest.mark.parametrize("launch", ["data1", "data2"])
@pytest.mark.parametrize("model", ["acoustic", "vocoder"])
def test_steps_match_jax_tp_step(tp, model, launch):
    """Steps 1 and 2 of both launches within tests/test_tensor_parallel.py's
    bounds of JAX's TP step, and data 2 x model 2 within them of the
    control."""
    i = {"acoustic": 0, "vocoder": 2}[model] if launch == "data1" else D2_RUNS.index(model)
    ranks = tp["ranks1"] if launch == "data1" else tp["ranks2"]
    rtol = AC_RTOL if model == "acoustic" else VOC_RTOL
    refs = {"JAX": tp["jax"][model], "control": tp["control"][{"acoustic": 0, "vocoder": 2}[model]]
            ["history"]}
    for r, res in enumerate(r[i] for r in ranks):
        for what, ref in refs.items():
            for step in range(2):
                for k, tols in rtol.items():
                    got, want = res["history"][step][k], ref[step][k]
                    assert abs(got - want) <= tols[step] * abs(want), (r, what, step, k, got, want)


@pytest.mark.parametrize("launch", ["data1", "data2"])
def test_whole_leaves_equal_everywhere_and_slices_across_data_groups(tp, launch):
    ranks = tp["ranks1"] if launch == "data1" else tp["ranks2"]
    for i in range(len(ranks[0])):
        res = [r[i] for r in ranks]
        assert [r["rank"] for r in res] == list(range(len(res)))
        assert len({r["whole_digest"] for r in res}) == 1
        assert len({r["digest"] for r in res}) == 1  # the gathered state
        for j, r in enumerate(res):
            assert r["shard_digest"] == res[j % M]["shard_digest"], (i, j)
        assert res[0]["shard_digest"] != res[1]["shard_digest"]  # the two halves differ
        assert res[0]["gather_calls"] > 0


def _expected_numel(run):
    """(replicated, sharded) elements of the whole state: parameters, both
    moments, the EMA copy."""
    cfg = run["cfg"]
    if run["model"] == "acoustic":
        parts = [([SAMBERTAcousticModel(cfg.acoustic_model)],
                  cfg.training.acoustic.ema_decay > 0)]
    else:
        m = HiFiGAN(cfg.vocoder)
        parts = [([m.generator], cfg.training.vocoder.ema_decay > 0), ([m.msd, m.mpd], False)]
    repl = shard = 0
    for modules, ema in parts:
        params = [p for mod in modules for p in mod.parameters()]
        for p, d in zip(params, param_dims(modules, M)):
            n = p.numel() * (4 if ema else 3)
            repl, shard = (repl + n, shard) if d is None else (repl, shard + n)
    return repl, shard


@pytest.mark.parametrize("name", D1_RUNS)
def test_persistent_state_is_replicated_plus_sharded_over_m(tp, name):
    i = D1_RUNS.index(name)
    repl, shard = _expected_numel(tp["d1"][i])
    assert shard % M == 0 and shard > repl
    assert tp["control"][i]["persistent_numel"] == repl + shard
    for ranks in (tp["ranks1"], tp["ranks2"] if i in (0, 2) else []):
        j = i if ranks is tp["ranks1"] else i // 2
        for r in ranks:
            assert r[j]["persistent_numel"] == repl + shard // M, (name, r[j]["rank"])


# ---- the command lines ---------------------------------------------------------------


def _yamls(tmp_path):
    model = tmp_path / "tiny.yaml"
    model.write_text(yaml.safe_dump({
        "acoustic_model": {"d_model": 32, "encoder": {"n_layers": 1, "n_heads": 2, "d_ff": 64},
                           "decoder": {"n_layers": 1, "n_heads": 2, "d_ff": 64}},
        "vocoder": {"generator": {"upsample_initial_channel": 32,
                                  "resblock_kernel_sizes": [3],
                                  "resblock_dilation_sizes": [[1, 3]]},
                    "discriminator": {"channel_div": 16}}}))
    root = tmp_path / "config.yaml"  # a background save after every step
    root.write_text(yaml.safe_dump({"training": {"acoustic": {"save_interval": 1},
                                                 "vocoder": {"save_interval": 1}}}))
    return ["--config", str(root), "--model-config", str(model)]


def _cmd(module, nproc, args):
    head = [sys.executable]
    if nproc:
        head += ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc)]
    return [*head, "-m", f"sambert_hifigan_tpu_torch.{module}", *args]


def _run(legs, tmp_path):
    """Every (name, module, nproc (0: one plain process), args) at once;
    {name: output}, after asserting each exited 0."""
    outs = mp.run_procs([_cmd(m, n, a) for _, m, n, a in legs],
                        [tmp_path / f"{name}.log" for name, *_ in legs], TIMEOUT,
                        mp.clean_env(OMP_NUM_THREADS="1"))
    return {name: (rc, out) for (name, *_), (rc, out) in zip(legs, outs)}


def _payload(directory, step):
    tree, got = CheckpointManager(directory, pcfg.AudioConfig()).restore_tree(step)
    assert got == step
    return tree


def _assert_equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_model_parallel_under_torchrun_writes_the_one_process_checkpoint(tmp_path):
    """`--model-parallel 2` under torchrun (data 1 x model 2, background
    saves of the gathered state, the vocoder's in bf16) writes checkpoints
    bit-equal to one process's; each resumes at the other model size to
    equal states; the model = 2 checkpoints load into the pipeline; and 3
    ranks at --model-parallel 2 refuse to start."""
    cfg = _yamls(tmp_path)
    d = {k: str(tmp_path / k) for k in ("ac1", "ac2", "voc1", "voc2", "bad")}

    def ac(ck, *extra):
        return ["--synthetic", "2", "--device", "cpu", "--batch-size", "2", *cfg,
                "--checkpoint-dir", ck, "--log-dir", str(tmp_path / "logs"), *extra]

    def voc(ck, *extra):
        return ["--synthetic", "2", "--device", "cpu", "--batch-size", "2", "--segment-frames",
                "8", "--save-precision", "bf16", *cfg, "--checkpoint-dir", ck, "--log-dir",
                str(tmp_path / "logs"), *extra]

    outs = _run([("ac2", "train_acoustic", 2, ac(d["ac2"], "--model-parallel", "2")),
                 ("ac1", "train_acoustic", 0, ac(d["ac1"])),
                 ("voc2", "train_vocoder", 2, voc(d["voc2"], "--model-parallel", "2")),
                 ("voc1", "train_vocoder", 0, voc(d["voc1"])),
                 ("bad", "train_acoustic", 3, ac(d["bad"], "--model-parallel", "2"))], tmp_path)
    for name in ("ac2", "ac1", "voc2", "voc1"):
        assert outs[name][0] == 0, outs[name][1]
    assert outs["ac2"][1].count("(data 1 x model 2)") == 2
    rc, out = outs["bad"]
    assert rc != 0 and "3 ranks not divisible by model=2" in out, out[-3000:]
    for a, b in (("ac1", "ac2"), ("voc1", "voc2")):
        for step in (1, 2):
            _assert_equal_trees(_payload(d[a], step), _payload(d[b], step), f"{a}/{b} {step}")

    # resume across model sizes: the model = 2 checkpoints at model = 1 and back
    outs = _run([("ac2to1", "train_acoustic", 0, ac(d["ac2"], "--resume", "--synthetic", "3")),
                 ("ac1to2", "train_acoustic", 2,
                  ac(d["ac1"], "--resume", "--synthetic", "3", "--model-parallel", "2")),
                 ("voc2to1", "train_vocoder", 0, voc(d["voc2"], "--resume", "--synthetic", "3")),
                 ("voc1to2", "train_vocoder", 2,
                  voc(d["voc1"], "--resume", "--synthetic", "3", "--model-parallel", "2"))],
                tmp_path)
    for name, (rc, out) in outs.items():
        assert rc == 0 and "resumed from step 2" in out, out[-3000:]
    for a, b in (("ac1", "ac2"), ("voc1", "voc2")):
        _assert_equal_trees(_payload(d[a], 3), _payload(d[b], 3), f"{a}/{b} 3")

    from sambert_hifigan_tpu_torch.config import load_config
    from sambert_hifigan_tpu_torch.pipeline import build_pipeline

    tts = build_pipeline(load_config(*cfg[1::2]), device="cpu", acoustic_checkpoint=d["ac2"],
                         vocoder_checkpoint=d["voc2"])
    wav = tts.synthesize("你好")
    assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()


def test_train_vocoder_sync_save_writes_what_the_background_save_writes(tmp_path):
    """`train_vocoder --sync-save` (interval saves in the step loop) and the
    default background save write equal checkpoints at every step."""
    cfg = _yamls(tmp_path)
    for mode, extra in (("sync", ["--sync-save"]), ("background", [])):
        train_vocoder.main(["--synthetic", "2", "--device", "cpu", "--batch-size", "2",
                            "--segment-frames", "8", *cfg, "--checkpoint-dir",
                            str(tmp_path / mode), "--log-dir", str(tmp_path / "logs"), *extra])
    for step in (1, 2):
        _assert_equal_trees(_payload(tmp_path / "sync", step),
                            _payload(tmp_path / "background", step), f"step {step}")
