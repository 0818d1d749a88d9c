"""The port's vocoder models against the JAX package, float32 on the CPU:
the discriminators' weight-normed and spectral-normed convolutions, MSD and
MPD with every feature map, weight norm folded and re-split, the exact
parameter counts, and the differentiable generator forward.

JAX parameters are random numpy arrays of the shapes `jax.eval_shape` gives
for `HiFiGAN.init_all` (no init compile), carried into the port with
`weights.vocoder_state_dicts_from_flax`.  The JAX MSD keeps its default
chained-folded ladder (msd_fold_max = 8); the port's plain layout gives the
same elements.  Tolerances are f32 reassociation noise and are stated per
test.  The helpers here are shared with tests/test_torch_vocoder_*.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sambert_hifigan_tpu import config as jcfg
from sambert_hifigan_tpu.models import hifigan as j_hg
from sambert_hifigan_tpu.models import layers as j_layers

from sambert_hifigan_tpu_torch import config as pcfg
from sambert_hifigan_tpu_torch.models import hifigan as p_hg
from sambert_hifigan_tpu_torch.models import layers as p_layers
from sambert_hifigan_tpu_torch.weights import (
    conv_state_dict_from_flax,
    vocoder_state_dicts_from_flax,
)

HOP = 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this module's tiny shapes: the suite's
    workers run side by side, and torch's default of a thread per core in
    each of them oversubscribes the host (a 2 s test took 140 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_voc(c, spectral=False, **disc):
    """TINY_VOC of tests/test_training.py (generator 32 channels, one
    ResBlock of dilations (1, 3), discriminators at channel_div 16) in the
    config module `c` of either package."""
    return c.VocoderConfig(
        generator=c.GeneratorConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                    resblock_dilation_sizes=((1, 3),)),
        discriminator=c.DiscriminatorConfig(channel_div=16, msd_use_spectral_norm=spectral,
                                            mpd_use_spectral_norm=spectral, **disc),
    )


def _fill(tree, rng):
    """Random values for an abstract flax variable tree: kernels and weight
    norm's v U(+-1/sqrt(fan_in)), g = ||v|| times U(0.5, 1.5) (so g and v
    are independent), biases U(+-0.1), spectral u, v unit normal draws."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"g", "v"}:
            vv = rng.uniform(-1, 1, v["v"].shape) / math.sqrt(math.prod(v["v"].shape[:-1]))
            norm = np.sqrt((vv ** 2).sum(axis=tuple(range(vv.ndim - 1))))
            out[k] = {"v": vv.astype(np.float32),
                      "g": (norm * rng.uniform(0.5, 1.5, norm.shape)).astype(np.float32)}
        elif isinstance(v, dict):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            bound = 1 / math.sqrt(math.prod(v.shape[:-1]))
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
        elif k in ("u", "v"):
            x = rng.standard_normal(v.shape)
            out[k] = (x / np.linalg.norm(x)).astype(np.float32)
        else:
            out[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
    return out


def jax_variables(module, seed, *args, **kwargs):
    """Random numpy variables ({'params', maybe 'spectral'}) for a flax module."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return _fill(jax.tree.map(lambda s: s, dict(shapes)), np.random.default_rng(seed))


def jax_vocoder(voc, seed):
    """(flax HiFiGAN, its random numpy variables)."""
    model = j_hg.HiFiGAN(voc)
    return model, jax_variables(model, seed, jnp.zeros((1, 80, 8)), method=j_hg.HiFiGAN.init_all)


def port_vocoder(voc_p, variables):
    port = p_hg.HiFiGAN(voc_p)
    port.load_state_dict(vocoder_state_dicts_from_flax(variables["params"],
                                                       variables.get("spectral")))
    return port


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(ours, theirs, rel):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = max(np.abs(theirs).max(), 1e-30)
    assert np.abs(ours - theirs).max() <= rel * scale, np.abs(ours - theirs).max() / scale


# ---- single layers -------------------------------------------------------------

LAYERS = {
    "conv1d-wn": (dict(in_channels=8, out_channels=16, kernel_size=41, stride=4, groups=4,
                       padding=20), (2, 8, 300)),
    "conv1d-sn": (dict(in_channels=8, out_channels=16, kernel_size=5, padding=2), (2, 8, 50)),
    "conv2d-wn": (dict(in_channels=4, out_channels=8, kernel_size=(5, 1), stride=(3, 1),
                       padding=(2, 0)), (2, 4, 40, 3)),
    "conv2d-sn": (dict(in_channels=4, out_channels=8, kernel_size=(5, 1), stride=(3, 1),
                       padding=(2, 0)), (2, 4, 40, 3)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_norm_conv_layer_matches_jax(name):
    """Output within 1e-5 (relative to its max).  Spectral norm: one
    advancing call (flax mutable=['spectral']) moves u, v as the JAX layer
    does (within 1e-5); a call that does not advance (the G pass, eval)
    reads them and leaves them alone on both sides."""
    kw, shape = LAYERS[name]
    spectral = name.endswith("sn")
    conv2d = name.startswith("conv2d")
    jmod = (j_layers.Conv2d if conv2d else j_layers.Conv1d)(
        **kw, weight_norm=not spectral, spectral_norm=spectral)
    x = _np(7, *shape)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1) if conv2d else x.transpose(0, 2, 1))
    variables = jax_variables(jmod, 11, xj)
    port_cls = p_layers.NormConv2d if conv2d else p_layers.NormConv1d
    port = port_cls(**kw, norm="spectral" if spectral else "weight")
    port.load_state_dict(conv_state_dict_from_flax(variables["params"], variables.get("spectral")))

    def to_torch_layout(y):
        y = np.asarray(y)
        return y.transpose(0, 3, 1, 2) if conv2d else y.transpose(0, 2, 1)

    if spectral:
        yj, new = jmod.apply(variables, xj, mutable=["spectral"])
        y = port(torch.from_numpy(x), advance=True)
        _close(port.spectral_u.numpy(), new["spectral"]["u"], 1e-5)
        _close(port.spectral_v.numpy(), new["spectral"]["v"], 1e-5)
        u_before = port.spectral_u.clone()
        y_read = port(torch.from_numpy(x))
        assert torch.equal(port.spectral_u, u_before)
        yj_read = jmod.apply({**variables, "spectral": new["spectral"]}, xj)
        _close(y_read.detach().numpy(), to_torch_layout(yj_read), 1e-5)
    else:
        yj = jmod.apply(variables, xj)
        y = port(torch.from_numpy(x))
    _close(y.detach().numpy(), to_torch_layout(yj), 1e-5)


# ---- MSD and MPD ---------------------------------------------------------------


_VOCODERS = {}


def _vocoders(spectral):
    """(spectral, flax HiFiGAN, variables, port HiFiGAN), built once per norm."""
    if spectral not in _VOCODERS:
        jmodel, variables = jax_vocoder(tiny_voc(jcfg, spectral), 3)
        _VOCODERS[spectral] = (spectral, jmodel, variables,
                               port_vocoder(tiny_voc(pcfg, spectral), variables))
    return _VOCODERS[spectral]


@pytest.fixture(params=[False, True], ids=["weight-norm", "spectral-norm"])
def vocoders(request):
    return _vocoders(request.param)


def test_discriminate_matches_jax(vocoders):
    """Every logit and feature map of the 3 MSD and 5 MPD critics, for real
    and fake inputs of 2099 samples (a prime: every MPD critic reflect-pads),
    within 1e-5 of each map's max; with spectral norm the D pass's advanced
    u, v within 1e-5 too (two iterations per critic: real, then fake)."""
    spectral, jmodel, variables, port = vocoders
    real, fake = _np(20, 2, 1, 2099, scale=0.3), _np(21, 2, 1, 2099, scale=0.3)
    kwargs = {"mutable": ["spectral"]} if spectral else {}
    theirs = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, method=j_hg.HiFiGAN.discriminate, **kwargs))(variables, real, fake)
    if spectral:
        theirs, new = theirs
        port = port_vocoder(tiny_voc(pcfg, spectral), variables)  # fresh u, v
    with torch.no_grad():
        ours = port.discriminate(torch.from_numpy(real), torch.from_numpy(fake),
                                 advance=spectral)
    assert len(ours) == len(theirs) == 8
    for i in (0, 2, 4, 6):  # logits
        assert len(ours[i]) == len(theirs[i]) == (3 if i < 4 else 5)
        for o, t in zip(ours[i], theirs[i]):
            _close(o.numpy(), t, 1e-5)
    for i in (1, 3, 5, 7):  # feature maps
        for critic_o, critic_t in zip(ours[i], theirs[i]):
            assert len(critic_o) == len(critic_t) == (8 if i < 4 else 6)
            for o, t in zip(critic_o, critic_t):
                _close(o.numpy(), t, 1e-5)
    if spectral:
        sd = vocoder_state_dicts_from_flax(variables["params"], new["spectral"])
        for k, v in port.state_dict().items():
            if "spectral_" in k:
                _close(v.numpy(), sd[k].numpy(), 1e-5)


def test_remove_and_apply_weight_norm_keep_the_output():
    """Folding (g, v) into the effective weight and re-splitting it leave
    every discriminator output within 1e-6; the folded pairs match the JAX
    package's remove_weight_norm within 1e-6."""
    _, _, variables, port = _vocoders(False)
    port = port_vocoder(tiny_voc(pcfg), variables)  # its own copy: this test changes it
    wav = torch.from_numpy(_np(22, 2, 1, 1024, scale=0.3))
    with torch.no_grad():
        before = port.msd(wav)[0] + port.mpd(wav)[0]
        p_layers.remove_weight_norm(port)
        folded = {k: v.clone() for k, v in port.state_dict().items()}
        mid = port.msd(wav)[0] + port.mpd(wav)[0]
        p_layers.apply_weight_norm(port)
        after = port.msd(wav)[0] + port.mpd(wav)[0]
    for a, b, c in zip(before, mid, after):
        _close(b.numpy(), a.numpy(), 1e-6)
        _close(c.numpy(), a.numpy(), 1e-6)
    want = vocoder_state_dicts_from_flax(
        jax.device_get(j_layers.remove_weight_norm(variables["params"])))
    for k in folded:
        if k.endswith(("weight_g", "weight_v")):
            _close(folded[k].numpy(), want[k].numpy(), 1e-6)


def test_parameter_counts():
    """channel_div 1: the MSD and MPD counts of docs/coverage.md C16/C18,
    counted on the meta device (no 70M parameters allocated); channel_div 16:
    every port parameter tensor has a JAX counterpart of the same size."""
    with torch.device("meta"):
        full = p_hg.HiFiGAN(pcfg.VocoderConfig())
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(full.msd) == 29_622_918
    assert count(full.mpd) == 41_105_770
    _, variables = jax_vocoder(tiny_voc(jcfg), 0)
    port = p_hg.HiFiGAN(tiny_voc(pcfg))
    j_count = sum(x.size for x in jax.tree.leaves(variables["params"]))
    assert count(port) == j_count


# ---- the generator -------------------------------------------------------------


def test_generator_forward_matches_jax_and_k2_plain():
    """The differentiable forward against the flax generator (within 1e-5
    of the max sample) and against the inference path through the K2
    wrapper's plain version with f32 weights (within 1e-6), 8 frames."""
    voc_j, voc_p = tiny_voc(jcfg), tiny_voc(pcfg)
    jgen = j_hg.HiFiGANGenerator(voc_j.generator)
    mel = _np(30, 2, 80, 8)
    variables = jax_variables(jgen, 5, jnp.asarray(mel))
    port = p_hg.HiFiGANGenerator(voc_p.generator)
    sd = vocoder_state_dicts_from_flax({"generator": variables["params"], "msd": {}, "mpd": {}})
    port.load_state_dict({k[len("generator."):]: v for k, v in sd.items()})
    theirs = np.asarray(jax.jit(jgen.apply)(variables, mel))
    with torch.no_grad():
        ours = port(torch.from_numpy(mel))
        via_k2 = port(torch.from_numpy(mel), port.pack(torch.float32))
    assert ours.shape == (2, 1, 8 * HOP)
    _close(ours.numpy(), theirs, 1e-5)
    _close(via_k2.numpy(), ours.numpy(), 1e-6)
