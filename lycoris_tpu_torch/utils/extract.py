"""SVD extraction of a LoCon from the difference of two models (counterpart
of ``lycoris_tpu/utils/extract.py``; reference lycoris/utils/__init__.py:52-353).

The contract is the JAX package's:

- rank modes fixed | threshold | ratio | quantile (percentile) | full, and
  the fall back to "full" when the rank reaches half the output dim;
- a convolution is decomposed as (O, I*kh*kw): A = Vh, B = U diag(S);
- with ``small_conv`` a second, CP pass on a kxk convolution's A gives
  ``lora_mid``, and the sparse residual is that of the delta (the
  reference subtracts the rebuild from the tuned weight, a bug);
- an optional sparse residual as COO ``bias_indices`` (int16, so indices
  past 32767 overflow, as in the reference), ``bias_values``, ``bias_size``;
- norms and embeddings only in full mode, as ``w_norm``/``b_norm`` or
  ``diff``/``diff_b``;
- fp16 values under the ``lora_te``/``lora_te{i}``/``lora_unet`` prefixes.

The layers' deltas are grouped by their 2-d shape and each group goes
through one batched ``torch.linalg.svd(stack, full_matrices=False)`` in
fp32 on ``extract_device`` (on CUDA with cuSOLVER's ``gesvd``, see
:func:`_svd`); the data-dependent rank choice reads S on the host with
numpy, as the JAX code does, since it sizes the outputs.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from ..logging import logger
from ..modules.base import LayerInfo

def _quantile(flat_sorted: torch.Tensor, q: float) -> torch.Tensor:
    """``np.quantile(a, q)`` (method "linear") of a sorted 1-d float tensor,
    step for step in its dtype as numpy computes it for a float array and
    a Python float ``q``."""
    n = flat_sorted.numel()
    virtual = (n - 1) * torch.tensor(q, dtype=flat_sorted.dtype)
    prev = torch.floor(virtual)
    gamma = virtual - prev
    lo = min(max(int(prev), 0), n - 1)
    hi = min(lo + 1, n - 1)
    a, b = flat_sorted[lo].cpu(), flat_sorted[hi].cpu()
    diff = b - a
    # numpy's _lerp: from the upper end where gamma >= 0.5
    return b - diff * (1 - gamma) if float(gamma) >= 0.5 else a + diff * gamma


def make_sparse(t: torch.Tensor, sparsity: float = 0.95) -> torch.Tensor:
    """``t`` with the elements of ``|t|`` under its ``sparsity`` quantile set to 0."""
    abs_t = t.abs()
    quan = _quantile(abs_t.reshape(-1).sort().values, sparsity)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(abs_t < quan.to(t.device), zero, t)


def _select_rank(S: np.ndarray, mode: str, mode_param) -> int:
    if mode == "fixed":
        return int(mode_param)
    if mode == "threshold":
        assert mode_param >= 0
        return int(np.sum(S > mode_param))
    if mode == "ratio":
        assert 1 >= mode_param >= 0
        return int(np.sum(S > S.max() * mode_param))
    if mode in ("quantile", "percentile"):
        assert 1 >= mode_param >= 0
        s_cum = np.cumsum(S)
        return int(np.sum(s_cum < mode_param * S.sum()))
    raise NotImplementedError('Extract mode should be "fixed", "threshold", "ratio" or "quantile"')


def _svd(w2d: torch.Tensor):
    """The thin SVD in fp32 of one matrix or a stack. On CUDA by cuSOLVER's
    QR-based ``gesvd``: torch's default there, the Jacobi ``gesvdj``, stops
    at a tolerance whose error the CP pass's rank cut amplified to 1.7e-2
    against the CPU's LAPACK, and it took 1.8x as long on a model's
    (1280, 1280) delta (PERF.md, the tools findings)."""
    w = w2d.to(torch.float32)
    return torch.linalg.svd(w, full_matrices=False, driver="gesvd" if w.is_cuda else None)


def _host(S) -> np.ndarray:
    return S.detach().to("cpu", torch.float32).numpy()


def _finish_low_rank(U, S, Vh, rank):
    return U[:, :rank] * S[:rank][None, :], Vh[:rank, :]


def extract_linear(weight, mode="fixed", mode_param=0, svd=None):
    """((A, B, residual), "low rank") or (weight, "full"); ``svd`` is the
    (U, S, Vh) of ``weight`` if already computed."""
    out_ch, in_ch = weight.shape
    if mode == "full":
        return weight, "full"
    U, S, Vh = svd if svd is not None else _svd(weight)
    rank = _select_rank(_host(S), mode, mode_param)
    rank = min(out_ch, in_ch, max(1, rank))
    if rank >= out_ch / 2:
        return weight, "full"
    U, Vh = _finish_low_rank(U, S, Vh, rank)
    diff = weight - U @ Vh
    return (Vh.reshape(rank, in_ch), U.reshape(out_ch, rank), diff), "low rank"


def extract_conv(weight, mode="fixed", mode_param=0, is_cp=False, svd=None):
    """:func:`extract_linear` on the (O, I*k) view of a convolution's
    weight; A is (rank, I, *k), B (O, rank, 1, ...). ``is_cp`` keeps the
    low rank past half the output dim (the CP pass)."""
    out_ch, in_ch, *k = weight.shape
    if mode == "full":
        return weight, "full"
    U, S, Vh = svd if svd is not None else _svd(weight.reshape(out_ch, -1))
    rank = _select_rank(_host(S), mode, mode_param)
    rank = min(out_ch, in_ch, max(1, rank))
    if rank >= out_ch / 2 and not is_cp:
        return weight, "full"
    U, Vh = _finish_low_rank(U, S, Vh, rank)
    diff = weight - (U @ Vh).reshape(weight.shape)
    A = Vh.reshape(rank, in_ch, *k)
    B = U.reshape(out_ch, rank, *(1 for _ in k))
    return (A, B, diff), "low rank"


# ---------------------------------------------------------------------------
# Whole-model diff extraction
# ---------------------------------------------------------------------------

UNET_TARGET = ["Linear", "Conv2d", "LayerNorm", "GroupNorm", "GroupNorm32", "Dense", "Conv"]
TE_TARGET = ["Embedding", "Embed", *UNET_TARGET]
LORA_PREFIX_UNET = "lora_unet"
LORA_PREFIX_TEXT_ENCODER = "lora_te"
_EMBEDDINGS = ("Embed", "Embedding")


def _leaf_weights(graph, targets) -> dict:
    """{name: (class name, LayerInfo, weight, bias)} of the target layers;
    an embedding counts as a (vocab, dim) linear, as in the JAX graph."""
    out = {}
    for name, node in graph.named_modules():
        if node.class_name not in targets:
            continue
        if node.is_leaf:
            w, b = node.weights()
            out[name] = (node.class_name, node.layer_info, w, b)
        elif node.class_name in _EMBEDDINGS and isinstance(getattr(node.module, "weight", None),
                                                            torch.Tensor):
            w = node.module.weight
            out[name] = (node.class_name, LayerInfo.linear(w.shape[0], w.shape[1], False, name),
                         w, None)
    return out


def _f16(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float16).cpu()


def extract_diff(
    base_tes,
    db_tes,
    base_unet,
    db_unet,
    mode="fixed",
    linear_mode_param=0,
    conv_mode_param=0,
    extract_device="cuda",
    use_bias=False,
    sparsity=0.98,
    small_conv=True,
    svd_log: list | None = None,
) -> dict:
    """Per-layer SVD of (W_db - W_base) over matched model trees, each a
    :class:`~lycoris_tpu_torch.graph.ModelGraph` (of a module or of a state
    dict) or an ``nn.Module``; the SVDs run on ``extract_device``. Returns a
    flat state dict of fp16 CPU tensors in the reference key grammar
    (utils/__init__.py:157-353). ``svd_log``, if given, gets one
    ``{"shape", "count", "seconds"}`` for each batched SVD."""
    from ..wrapper import _as_graph

    dev = torch.device(extract_device)
    base_tes = [_as_graph(t) for t in (base_tes or [])]
    db_tes = [_as_graph(t) for t in (db_tes or [])]
    base_unet = _as_graph(base_unet)
    db_unet = _as_graph(db_unet)

    def make_state_dict(prefix, base_graph, db_graph, targets):
        loras = {}
        base_leaves = _leaf_weights(base_graph, targets)
        db_leaves = _leaf_weights(db_graph, targets)
        shared = [n for n in db_leaves if n in base_leaves]
        weights = {}
        for name in shared:
            w_base = base_leaves[name][2].detach().to(dev)
            w_db = db_leaves[name][2].detach().to(dev)
            # "layer unchanged": numpy's allclose tolerances, in fp32
            if not torch.allclose(w_base.float(), w_db.float()):
                weights[name] = (w_base, w_db)

        # batched SVD: the 2-d deltas grouped by shape, one call a group; each
        # layer's low-rank result is taken before the next group
        results = {}
        if mode != "full":
            groups = defaultdict(list)
            for name in weights:
                cls, li, _, _ = base_leaves[name]
                if cls in _EMBEDDINGS:
                    continue  # embeddings never low-rank (full mode only)
                if li.module_type == "linear" or li.is_conv:
                    w_base, w_db = weights[name]
                    groups[(w_base.shape[0], w_base[0].numel())].append(name)
            for shape, names in groups.items():
                # delta = tuned - base (reference: root_weight - weights.weight
                # with root = the db tree, utils/__init__.py:228-233)
                deltas = [weights[n][1] - weights[n][0] for n in names]
                stacked = torch.stack([d.reshape(shape).to(torch.float32) for d in deltas])
                t0 = time.perf_counter()
                U, S, Vh = _svd(stacked)
                S_host = _host(S)  # the rank choice reads S on the host (and syncs)
                if svd_log is not None:
                    svd_log.append({"shape": list(shape), "count": len(names),
                                    "seconds": time.perf_counter() - t0})
                del stacked
                for i, name in enumerate(names):
                    li = base_leaves[name][1]
                    svd = (U[i], torch.from_numpy(S_host[i]).to(dev), Vh[i])
                    if li.module_type == "linear":
                        results[name] = extract_linear(deltas[i], mode, linear_mode_param, svd=svd)
                    else:
                        is_linear = all(kk == 1 for kk in li.shape[2:])
                        results[name] = extract_conv(
                            deltas[i], mode, linear_mode_param if is_linear else conv_mode_param,
                            svd=svd)
                del U, S, Vh, deltas

        for name in shared:
            if name not in weights:
                continue
            cls, li, _, b_base = base_leaves[name]
            b_db = db_leaves[name][3]
            w_base, w_db = weights[name]
            lora_name = (prefix + "." + name).replace(".", "_")
            layer_kind = li.module_type
            is_embedding = cls in _EMBEDDINGS
            if mode == "full":
                decompose_mode = "full"
            elif is_embedding or li.is_norm or (not li.is_conv and layer_kind != "linear"):
                # norms and embeddings are only stored in full mode
                # (reference utils/__init__.py:236-246 'else: continue')
                continue
            else:
                weight, decompose_mode = results[name]
                if decompose_mode == "low rank":
                    extract_a, extract_b, diff = weight
                    is_linear = all(kk == 1 for kk in li.shape[2:])
                    if li.is_conv and small_conv and not is_linear:
                        dim = extract_a.shape[0]
                        (extract_c, extract_a, _), _ = extract_conv(
                            extract_a.transpose(0, 1), "fixed", dim, is_cp=True)
                        extract_a = extract_a.transpose(0, 1)
                        extract_c = extract_c.transpose(0, 1)
                        loras[f"{lora_name}.lora_mid.weight"] = _f16(extract_c)
                        # the residual of the DELTA (the reference subtracts the
                        # rebuild from root_weight, a bug: the COO bias must
                        # complete the delta, not the absolute weight)
                        diff = (w_db - w_base) - torch.einsum(
                            "ijkl,jr,pi->prkl", extract_c,
                            extract_a.reshape(extract_a.shape[0], -1),
                            extract_b.reshape(extract_b.shape[0], -1))

            if decompose_mode == "low rank":
                loras[f"{lora_name}.lora_down.weight"] = _f16(extract_a)
                loras[f"{lora_name}.lora_up.weight"] = _f16(extract_b)
                loras[f"{lora_name}.alpha"] = torch.tensor([extract_a.shape[0]],
                                                           dtype=torch.float16)
                if use_bias:
                    d = diff.reshape(extract_b.shape[0], -1)
                    sparse = make_sparse(d, sparsity)
                    idx = torch.nonzero(sparse, as_tuple=True)
                    loras[f"{lora_name}.bias_indices"] = torch.stack(idx).to(torch.int16).cpu()
                    loras[f"{lora_name}.bias_values"] = _f16(sparse[idx])
                    loras[f"{lora_name}.bias_size"] = torch.tensor(list(d.shape), dtype=torch.int16)
            elif decompose_mode == "full":
                w_key, b_key = ("w_norm", "b_norm") if li.is_norm else ("diff", "diff_b")
                loras[f"{lora_name}.{w_key}"] = _f16(w_db - w_base)
                if b_base is not None and b_db is not None:
                    loras[f"{lora_name}.{b_key}"] = _f16(b_db.to(dev) - b_base.to(dev))
            else:
                raise NotImplementedError
        return loras

    all_loras = {}
    all_loras |= make_state_dict(LORA_PREFIX_UNET, base_unet, db_unet, UNET_TARGET)
    for idx, (te1, te2) in enumerate(zip(base_tes, db_tes)):
        prefix = LORA_PREFIX_TEXT_ENCODER + (f"{idx + 1}" if len(base_tes) > 1 else "")
        all_loras |= make_state_dict(prefix, te1, te2, TE_TARGET)

    names = {k.rsplit(".", 1)[0] for k in all_loras}
    logger.info(f"{len(names)} modules extracted")
    return all_loras
