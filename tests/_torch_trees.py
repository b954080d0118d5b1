"""Packed trees and KV caches built by both packages from one seed, for
the port's checkpoint, analyzer and uploader tests.

Reduced smollm-135m (2 layers, d_model 128).  The reference's
``Model.init`` weights go to the port through ``params_from_jax``; both
packages quantize, plan and pack them (their streams are byte-equal,
``test_torch_serving.py``).  A KV cache gets seeded content through the
port's append, and the reference's cache is built over the same page
words.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import api as ref_api
from repro.configs import get_config
from repro.core.iris import LayoutCache as RefCache
from repro.kvcache import KVManifest as RefKVManifest
from repro.kvcache import PackedKVCache as RefKV
from repro.models.model import Model
from repro.quant import QuantSpec as RefSpec
from repro_torch import configs as port_configs
from repro_torch.core.iris import LayoutCache as PortCache
from repro_torch.kvcache import PackedKVCache as PortKV
from repro_torch.models.params import params_from_jax
from repro_torch.quant import QuantSpec
from repro_torch.tree import pack_tree

MAX_SEQ = 32
N_SLOTS = 4


def configs_and_params():
    """(reference config, port config, reference params, numpy params)."""
    rcfg = get_config("smollm-135m").reduced()
    pcfg = port_configs.SMOLLM_135M.reduced()
    params = Model(rcfg, remat="none").init(jax.random.PRNGKey(0))
    return rcfg, pcfg, params, jax.tree.map(np.asarray, params)


def trees(models, bits: int):
    """(reference tree, port tree on the CPU) packed from one weight set."""
    rcfg, pcfg, params, np_params = models
    rt = ref_api.pack_tree(rcfg, params, RefSpec(bits=bits, group_size=32),
                           cache=RefCache())
    pt = pack_tree(pcfg, params_from_jax(np_params, device="cpu"),
                   QuantSpec(bits=bits, group_size=32), cache=PortCache(),
                   device="cpu")
    return rt, pt


def filled_kv(pcfg, bits: int, *, seed: int = 0, n_tokens: int = 3):
    """A port KV cache on the CPU with ``n_tokens`` seeded tokens appended
    to every slot of every layer (slot ``i`` starts at position ``i``)."""
    kvc = PortKV.create(pcfg, bits=bits, page_tokens=8, n_slots=N_SLOTS,
                        max_seq=MAX_SEQ, cache=PortCache(), device="cpu")
    rng = np.random.default_rng(seed)
    slots = torch.arange(N_SLOTS)
    shape = (N_SLOTS, pcfg.n_kv_heads, pcfg.head_dim)
    for t in range(n_tokens):
        for layer in range(pcfg.n_layers):
            k = torch.from_numpy(rng.standard_normal(shape, np.float32))
            v = torch.from_numpy(rng.standard_normal(shape, np.float32))
            kvc.append(k, v, slots + t, slots, layer=layer)
    return kvc


def ref_kv_like(kvc):
    """The reference's cache over the same page words and manifest."""
    return RefKV(jnp.asarray(kvc.host_pages()),
                 RefKVManifest.from_json_dict(kvc.manifest.to_json_dict()))
