"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
tiny configs in both packages and the weight carry from a JAX parameter
pytree to the port."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from covomix_tpu.models import acoustic as JA, text2semantic as JT, vocoder as JV
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as PA, text2semantic as PT, vocoder as PV

# These tests run the port's tiny shapes on the CPU in a process whose XLA
# client keeps its own threads busy; torch's intra-op pool then contends with
# it, and one torch thread is several times faster than the default.
torch.set_num_threads(1)

J_T2S = JT.T2SConfig(dim=32, source_depth=1, target_depth=1, heads=2, dim_head=16,
                     num_text_tokens=200, num_semantic_tokens=501, target_dim=64, two_output=True)
J_AC = JA.AcousticConfig(dim_in=160, dim=32, depth=2, heads=2, dim_head=16, dim_phoneme_emb=16,
                         num_phoneme_tokens=502, mode="two_one")
J_VOC = JV.VocoderConfig(upsample_initial_channel=16)
# tiny configs that a Lightning checkpoint's hyper_parameters map back to
# (`cfg_kwargs_from_hparams` reads no T2S head dim and no phoneme-embedding
# width, so those stay at their defaults)
J_T2S_CKPT = dataclasses.replace(J_T2S, dim_head=64)
J_AC_CKPT = dataclasses.replace(J_AC, dim_phoneme_emb=1024)

GREEDY_THRES = 1e-3   # ceil(1e-3 * 502) == 1: top-k keeps only the argmax, sampling is greedy


def port_cfg(port_cls, jax_cfg):
    """The port's config with the same field values as a JAX package config."""
    return port_cls(**dataclasses.asdict(jax_cfg))


P_T2S, P_AC, P_VOC = port_cfg(PT.T2SConfig, J_T2S), port_cfg(PA.AcousticConfig, J_AC), port_cfg(PV.VocoderConfig, J_VOC)


def to_port(jax_params, device="cpu"):
    """JAX parameter pytree -> the port's parameters (same names), via numpy."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params), device)


def jax_params(seed: int = 0):
    """(t2s, acoustic, vocoder) JAX parameters of the tiny configs."""
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.jit(JT.init, static_argnums=1)(k[0], J_T2S),
            jax.jit(JA.init, static_argnums=1)(k[1], J_AC),
            jax.jit(JV.init_generator, static_argnums=1)(k[2], J_VOC))


def tree_shapes(tree):
    """{path: shape} of a nested dict/list tree of arrays or tensors."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, f"{prefix}{key}/")
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(val, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = tuple(node.shape)

    walk(tree, "")
    return out
