"""The port's ConvNet3D against the JAX package's, same weights and inputs.

64x64x8 clips, 3 classes, random inputs (max-pool ties would route
gradients differently; PARITY.md §11). The JAX first stage is a fused
s2d2 conv + phase max that adds the bias after the pool; the port's is a
plain Conv3d + ReLU + MaxPool, the same math up to fp32 rounding
(ROADMAP C.4). Tolerance: 1e-4 of the largest |value| (fp32 convs summed
in other orders).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_distillation_tpu.distill.mtt import \
    flat_param_template as jax_template
from video_distillation_torch.distill.params import (from_jax_params,
                                                     layout_for)
from video_distillation_torch.models.registry import create_model

NC, F, IM, B = 3, 8, 64, 2
REL = 1e-4


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


@pytest.mark.parametrize("output", ["logits", "feat"])
def test_eval_forward_matches_jax(pair, output):
    model_def, params, port, x, _, _ = pair
    ref = model_def.apply({"params": params}, jnp.asarray(x), train=False,
                          output=output)
    out = port(torch.from_numpy(x), train=False, output=output)
    close(out.detach().numpy(), ref)


@pytest.mark.parametrize("train", [False, True])
def test_input_and_param_grads_match_jax(pair, train, monkeypatch):
    model_def, params, port, x, cot, mask = pair
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
    close(logits.detach().numpy(), ref_logits)
    close(xt.grad.numpy(), gx)
    want = from_jax_params(port, gp)
    for name, p in port.named_parameters():
        close(p.grad.numpy(), want[name].numpy())


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


def test_registry_names_the_roadmap_for_other_models():
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        create_model("ConvNet", 3, 10, (32, 32))


def test_flat_layout_counts_every_parameter(pair):
    _, _, port, _, _, _ = pair
    assert layout_for(port).size == sum(p.numel() for p in port.parameters())
