"""The port's ConvNet3D against the JAX package's, same weights and inputs.

64x64x8 clips, 3 classes, random inputs (max-pool ties would route
gradients differently; PARITY.md §11). Both packages fuse the first stage
by default: s2d2 pack, one stride-2 5x5 conv, the phase max, then the
bias. With the same formulation the port agrees within 3.9e-6 of the
largest |value| in every output and gradient (measured on an x86 CPU: fp32
convolutions summed in other orders), so the fused case is held at 1e-5.
The plain Conv3d + ReLU + MaxPool stage (``fuse_first_stage=False``) adds
the bias before the pool, the same math up to rounding: 7.5e-6 measured,
held at 1e-4 as before.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill.mtt import \
    flat_param_template as jax_template
from video_distillation_tpu.models import layers as jax_layers
from video_distillation_torch.distill.params import (from_jax_params,
                                                     layout_for)
from video_distillation_torch.models import layers
from video_distillation_torch.models.registry import create_model

NC, F, IM, B = 3, 8, 64, 2
REL = 1e-4
# tolerance by first stage: fused (the default) and plain Conv3d + pool
REL_BY_FUSE = {True: 1e-5, False: 1e-4}
FUSE = pytest.mark.parametrize("fuse", [True, False], ids=["fused", "plain"])


def close(a, ref, rel=REL):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    err, scale = np.abs(a - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, f"max error {err} > {rel} * {scale}"


@pytest.fixture(scope="module")
def pair():
    model_def, params, _, _ = jax_template("ConvNet3D", 3, NC, (IM, IM), F,
                                           seed=0)
    port = create_model("ConvNet3D", 3, NC, (IM, IM), F, device="cpu")
    port.load_state_dict(from_jax_params(port, params))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, F, IM, IM, 3)).astype(np.float32)
    cot = rng.normal(size=(B, NC)).astype(np.float32)
    # head dropout keep-mask in the JAX layout (B, T', H', W', C)
    mask = rng.random((B, 1, 1, 1, 128)) < 0.5
    return model_def, params, port, x, cot, mask


@pytest.fixture(scope="module")
def plain_port(pair):
    """The port with the plain Conv3d + pool first stage, same weights."""
    port = create_model("ConvNet3D", 3, NC, (IM, IM), F, device="cpu")
    port.fuse_first_stage = False
    port.load_state_dict(pair[2].state_dict())
    return port


def _port(pair, plain_port, fuse):
    return pair[2] if fuse else plain_port


def fixed_dropout(mask):
    """A flax Dropout that applies ``mask`` instead of drawing one."""

    class FixedDropout(flax.linen.Module):
        rate: float
        deterministic: bool = False

        def __call__(self, x):
            if self.deterministic or self.rate == 0:
                return x
            return jnp.where(jnp.asarray(mask), x / (1.0 - self.rate), 0.0)

    return FixedDropout


@FUSE
@pytest.mark.parametrize("output", ["logits", "feat"])
def test_eval_forward_matches_jax(pair, plain_port, output, fuse):
    model_def, params, _, x, _, _ = pair
    port = _port(pair, plain_port, fuse)
    ref = model_def.apply({"params": params}, jnp.asarray(x), train=False,
                          output=output)
    out = port(torch.from_numpy(x), train=False, output=output)
    close(out.detach().numpy(), ref, REL_BY_FUSE[fuse])


@FUSE
@pytest.mark.parametrize("train", [False, True])
def test_input_and_param_grads_match_jax(pair, plain_port, train, fuse,
                                         monkeypatch):
    model_def, params, _, x, cot, mask = pair
    port = _port(pair, plain_port, fuse)
    rel = REL_BY_FUSE[fuse]
    monkeypatch.setattr(flax.linen, "Dropout", fixed_dropout(mask))

    def jax_loss(p, xx):
        logits = model_def.apply({"params": p}, xx, train=train,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(logits * cot), logits

    (_, ref_logits), (gp, gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    port.zero_grad()
    logits = port(xt, train=train, keep_mask=torch.from_numpy(mask))
    (logits * torch.from_numpy(cot)).sum().backward()
    close(logits.detach().numpy(), ref_logits, rel)
    close(xt.grad.numpy(), gx, rel)
    want = from_jax_params(port, gp)
    for name, p in port.named_parameters():
        close(p.grad.numpy(), want[name].numpy(), rel)


def test_dropout_draws_from_the_generator(pair):
    _, _, port, x, _, _ = pair
    xt = torch.from_numpy(x)
    a = port(xt, train=True, generator=torch.Generator().manual_seed(1))
    b = port(xt, train=True, generator=torch.Generator().manual_seed(1))
    c = port(xt, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bf16_head_island_runs_the_head_in_fp32(pair):
    """With the head islanded, a bf16 forward's head stage is fp32: the
    logits equal the fp32 head applied to the bf16 backbone's features,
    rounded once to bf16."""
    _, _, port, x, _, _ = pair
    xb = torch.from_numpy(x).bfloat16()
    bf = {k: v.bfloat16() for k, v in port.state_dict().items()}
    out = torch.func.functional_call(port, bf, (xb,),
                                     dict(fp32_stages=("head",)))
    assert out.dtype == torch.bfloat16
    feat = torch.func.functional_call(port, bf, (xb,), dict(output="feat"))
    head_in = feat.float().view(B, 2, 1, 1, 128).permute(0, 4, 1, 2, 3)
    pooled = torch.nn.functional.avg_pool3d(head_in, (2, 1, 1), stride=1)
    ref = torch.nn.functional.conv3d(pooled, bf["head.weight"].float(),
                                     bf["head.bias"].float())
    ref = ref[:, :, :, 0, 0].amax(dim=2).bfloat16()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("name", ["ConvNetBN", "ConvNetASwishBN",
                                  "ResNet18", "KIP_ConvNet"])
def test_registry_names_the_roadmap_for_other_models(name):
    """The 2-D ConvNet (static learning) and the VideoConvNets are ported;
    the image models come with the image datasets."""
    with pytest.raises(NotImplementedError, match="ROADMAP A.15b"):
        create_model(name, 3, 10, (32, 32))


def test_flat_layout_counts_every_parameter(pair):
    _, _, port, _, _, _ = pair
    assert layout_for(port).size == sum(p.numel() for p in port.parameters())


def test_fused_stage_keeps_the_parameter_layout(pair, plain_port):
    """The fused stage reads the same (64, 3, 3, 7, 7) ``convs.0`` Conv3d
    parameters, so the flat order, ``from_jax_params`` and the expert
    buffers written by earlier versions and by the JAX package are
    unchanged: 3,647,666 values at 50 classes."""
    _, params, port, _, _, _ = pair
    assert port.fuses_first_stage(IM, IM) and not plain_port.fuses_first_stage(IM, IM)
    assert tuple(port.convs[0].weight.shape) == (64, 3, 3, 7, 7)
    assert layout_for(port).entries == layout_for(plain_port).entries
    for a, b in ((port, plain_port), (plain_port, port)):
        loaded = from_jax_params(a, params)
        assert {k: tuple(v.shape) for k, v in loaded.items()} == {
            k: tuple(v.shape) for k, v in b.state_dict().items()}
    big = create_model("ConvNet3D", 3, 50, (112, 112), 16, device="meta")
    assert layout_for(big).size == 3_647_666


@pytest.mark.parametrize("act,fused", [("relu", True), ("leakyrelu", True),
                                       ("sigmoid", True), ("swish", False)])
def test_first_stage_fuses_for_monotone_activations(act, fused):
    """JAX's condition (``convnet3d.py:93-97``): a monotone activation and
    H, W divisible by 4; swish keeps the plain stage."""
    from video_distillation_torch.models.convnet3d import ConvNet3D
    net = ConvNet3D(3, NC, net_act=act, device="meta")
    assert net.fuses_first_stage(64, 64) == fused
    assert not net.fuses_first_stage(64, 66)


def test_s2d2_conv_pool_matches_jax():
    """The fused stage alone: the port's packed-kernel gather and conv
    against ``_s2d2_conv_pool`` + ``_phase_max`` + bias, at 1e-6 of the
    largest |value| (fp32 convolutions summed in other orders)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 16, 12, 3)).astype(np.float32)
    kernel = rng.normal(size=(3, 7, 7, 3, 8)).astype(np.float32)
    bias = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_array_equal(layers._U2, jax_layers._U2)
    w2 = jnp.asarray(kernel).transpose(1, 2, 0, 3, 4).reshape(7, 7, 9, 8)
    ref = jax_layers._phase_max(jax_layers._s2d2_conv_pool(jnp.asarray(x), w2, 8))
    ref = (ref + bias).reshape(2, 4, 4, 3, 8)
    weight = torch.from_numpy(kernel).permute(4, 3, 0, 1, 2)
    out = layers.s2d2_conv_pool(torch.from_numpy(x), weight,
                                torch.from_numpy(bias))
    close(out.permute(0, 2, 3, 4, 1).numpy(), ref, 1e-6)
