"""The port's six CLIs (``python -m lycoris_tpu_torch.tools.<name> --device
cpu``) against the JAX package's ``tools/*.py`` on the same small files:
extract_locon (a rank-4 linear and 3x3 conv delta, the CP pass), merge (a
LoHa file saved under another prefix), pack_bundle, batch_bundle_convert
(pack, then unpack), batch_hcp_convert (SDXL webui -> HCP with the alpha
scale, then back) and sdxl_emb. The port's CLIs run as subprocesses where
the ``-m`` entry is what is tested, else in-process through ``main(argv)``;
the JAX tools run in-process (``runpy`` with their argv), so the whole file
starts six interpreters.
"""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import lycoris_tpu_torch as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
F16 = dict(atol=2e-3, rtol=2e-3)


def run_port(name, *args):
    """The port's CLI as ``python -m`` on the CPU; its stdout."""
    res = subprocess.run([sys.executable, "-m", f"lycoris_tpu_torch.tools.{name}", *args,
                          "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def run_jax(name, *args):
    """The JAX package's ``tools/<name>.py`` in this process."""
    argv = sys.argv
    sys.argv = [name, *args]
    try:
        runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = argv


def assert_files_equal(a, b, **tol):
    """The port's file ``a`` holds the JAX tool's file ``b``'s tensors: the
    same keys, dtypes and values, and shapes, but for a 0-d tensor, which
    the port writes as it read it and the JAX tools as shape (1,) (their
    ``np.ascontiguousarray``)."""
    x, y = load_file(a), load_file(b)
    assert set(x) == set(y)
    for k in x:
        assert x[k].dtype == y[k].dtype, k
        assert x[k].shape == y[k].shape or (x[k].shape == () and y[k].shape == (1,)), k
        x[k] = x[k].reshape(y[k].shape)
        if tol:
            np.testing.assert_allclose(x[k].astype(np.float32), y[k].astype(np.float32),
                                       err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_cli")
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    base = {"blocks.0.fc.weight": f32(64, 32), "blocks.0.fc.bias": f32(64),
            "blocks.0.conv.weight": f32(32, 16, 3, 3), "blocks.0.norm.weight": f32(32),
            "blocks.1.fc.weight": f32(48, 64)}
    db = dict(base)
    db["blocks.0.fc.weight"] = base["blocks.0.fc.weight"] + (f32(64, 4) @ f32(4, 32)) * 0.02
    db["blocks.0.conv.weight"] = base["blocks.0.conv.weight"] + (
        (f32(32, 4) @ f32(4, 144)) * 0.02).reshape(32, 16, 3, 3)
    paths = {k: str(d / f"{k}.safetensors") for k in ("base", "db")}
    save_file(base, paths["base"])
    save_file(db, paths["db"])
    # a LoHa file over the base's layers, saved by the port under its own prefix
    model = torch.nn.Module()
    model.blocks_0_fc = torch.nn.Linear(32, 64)
    model.blocks_0_conv = torch.nn.Conv2d(16, 32, 3)
    model.blocks_1_fc = torch.nn.Linear(64, 48, bias=False)
    net = tl.create_lycoris(model, 1.0, linear_dim=4, linear_alpha=2.0, conv_dim=4,
                            conv_alpha=2.0, algo="loha", device="cpu", seed=1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(2)) * 0.1)
    paths["loha"] = str(d / "loha.safetensors")
    net.save_weights(paths["loha"])
    # embeddings, text-encoder tables, an SDXL webui LoRA
    paths["run"] = str(d / "run-100.safetensors")
    save_file({"lora_unet_fc.lora_down.weight": f32(4, 8), "lora_unet_fc.alpha": f32()},
              paths["run"])
    for name in ("cat-100", "dog-100"):
        paths[name] = str(d / f"{name}.safetensors")
        save_file({"emb_params": f32(2, 8)}, paths[name])
    paths["te1"], paths["te2"] = str(d / "te1.safetensors"), str(d / "te2.safetensors")
    save_file({"text_model.embeddings.token_embedding.weight": f32(100, 12)}, paths["te1"])
    save_file({"text_model.embeddings.token_embedding.weight": f32(100, 20)}, paths["te2"])
    webui = {}
    for name in ("lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_q",
                 "lora_unet_middle_block_1_proj_out",
                 "lora_te1_text_model_encoder_layers_3_self_attn_q_proj",
                 "lora_te2_text_model_encoder_layers_30_mlp_fc1"):
        webui.update({f"{name}.lora_down.weight": f32(4, 16), f"{name}.lora_up.weight": f32(16, 4),
                      f"{name}.alpha": np.asarray(4.0, np.float32)})
    paths["webui"] = str(d / "sdxl_lora.safetensors")
    save_file(webui, paths["webui"])
    return d, paths, base, db


def rebuild(sd, name):
    up, down = sd[f"{name}.lora_up.weight"], sd[f"{name}.lora_down.weight"]
    up, down = up.astype(np.float32), down.astype(np.float32)
    if f"{name}.lora_mid.weight" in sd:
        mid = sd[f"{name}.lora_mid.weight"].astype(np.float32)
        return np.einsum("ijkl,jr,pi->prkl", mid, down.reshape(down.shape[0], -1),
                         up.reshape(up.shape[0], -1))
    return up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)


def test_extract_locon_cli(files):
    d, p, base, db = files
    out_t, out_j = str(d / "ext_t.safetensors"), str(d / "ext_j.safetensors")
    flags = ["--mode", "fixed", "--linear_dim", "4", "--conv_dim", "4", "--prefix", "lora_te"]
    assert "saved 7 tensors" in run_port("extract_locon", p["base"], p["db"], out_t, *flags)
    run_jax("extract_locon", p["base"], p["db"], out_j, *flags)
    t, j = load_file(out_t), load_file(out_j)
    assert set(t) == set(j) and "lora_te_blocks_0_conv.lora_mid.weight" in t
    for name in ("lora_te_blocks_0_fc", "lora_te_blocks_0_conv"):
        np.testing.assert_array_equal(t[f"{name}.alpha"], j[f"{name}.alpha"])
        np.testing.assert_allclose(rebuild(t, name), rebuild(j, name), **F16)
    # rank 4 <= dim 4: the linear delta comes back to fp16 rounding (the 3x3
    # conv's goes through the lossy CP pass)
    np.testing.assert_allclose(rebuild(t, "lora_te_blocks_0_fc"),
                               db["blocks.0.fc.weight"] - base["blocks.0.fc.weight"], **F16)


def test_merge_cli(files):
    d, p, base, _ = files
    out_t, out_j = str(d / "merged_t.safetensors"), str(d / "merged_j.safetensors")
    flags = ["--weight", "0.7", "--prefix", "lycoris"]
    assert "merged 3 modules" in run_port("merge", p["base"], p["loha"], out_t, *flags)
    run_jax("merge", p["base"], p["loha"], out_j, *flags)
    assert_files_equal(out_t, out_j, **TOL)
    merged = load_file(out_t)
    np.testing.assert_array_equal(merged["blocks.0.norm.weight"], base["blocks.0.norm.weight"])
    assert not np.array_equal(merged["blocks.0.fc.weight"], base["blocks.0.fc.weight"])


def test_pack_bundle_cli(files):
    d, p, _, _ = files
    out_t, out_j = str(d / "bundle_t.safetensors"), str(d / "bundle_j.safetensors")
    run_port("pack_bundle", p["run"], p["cat-100"], p["dog-100"], "-o", out_t)
    run_jax("pack_bundle", p["run"], p["cat-100"], p["dog-100"], "-o", out_j)
    assert_files_equal(out_t, out_j)
    assert "bundle_emb.cat-100.emb_params" in load_file(out_t)


def test_batch_bundle_convert_cli(files):
    d, p, _, _ = files
    src = d / "bundle_src"
    src.mkdir()
    for k in ("run", "cat-100", "dog-100"):
        os.link(p[k], src / os.path.basename(p[k]))
    outs = {w: d / f"bundles_{w}" for w in ("t", "j")}
    run_port("batch_bundle_convert", "pack", "--lora_path", str(src / "run-100.safetensors"),
             "--emb_path", str(src), "--dst_dir", str(outs["t"]))
    run_jax("batch_bundle_convert", "pack", "--lora_path", str(src / "run-100.safetensors"),
            "--emb_path", str(src), "--dst_dir", str(outs["j"]))
    packed = "run-bundle-100.safetensors"
    assert_files_equal(outs["t"] / packed, outs["j"] / packed)
    from lycoris_tpu_torch.tools import batch_bundle_convert

    batch_bundle_convert.main(["unpack", "--lora_path", str(outs["t"] / packed), "--dst_dir",
                               str(outs["t"] / "un"), "--device", "cpu"])
    run_jax("batch_bundle_convert", "unpack", "--lora_path", str(outs["j"] / packed),
            "--dst_dir", str(outs["j"] / "un"))
    names = sorted(os.listdir(outs["j"] / "un"))
    assert sorted(os.listdir(outs["t"] / "un")) == names and len(names) == 3
    for n in names:
        assert_files_equal(outs["t"] / "un" / n, outs["j"] / "un" / n)


def test_batch_hcp_convert_cli(files):
    d, p, _, _ = files
    outs = {w: d / f"hcp_{w}" for w in ("t", "j")}
    flags = ["--sdxl", "--auto_scale_alpha"]
    run_port("batch_hcp_convert", "from_webui", "--src", p["webui"], "--dst_dir",
             str(outs["t"]), *flags)
    run_jax("batch_hcp_convert", "from_webui", "--src", p["webui"], "--dst_dir",
            str(outs["j"]), *flags)
    names = sorted(os.listdir(outs["j"]))
    assert sorted(os.listdir(outs["t"])) == names == ["text_encoder-sdxl_lora.safetensors",
                                                      "unet-sdxl_lora.safetensors"]
    for n in names:
        assert_files_equal(outs["t"] / n, outs["j"] / n)
    from lycoris_tpu_torch.tools import batch_hcp_convert

    batch_hcp_convert.main(["to_webui", "--src", str(outs["t"]), "--dst_dir",
                            str(outs["t"] / "back"), "--save_fp16", "--device", "cpu", *flags])
    run_jax("batch_hcp_convert", "to_webui", "--src", str(outs["j"]), "--dst_dir",
            str(outs["j"] / "back"), "--save_fp16", *flags)
    back = "webui-sdxl_lora.safetensors"
    assert_files_equal(outs["t"] / "back" / back, outs["j"] / "back" / back)


def test_sdxl_emb_cli(files):
    d, p, _, _ = files
    out_t, out_j = str(d / "emb_t.safetensors"), str(d / "emb_j.safetensors")
    args = ["--te1", p["te1"], "--te2", p["te2"], "--ids", "3", "17", "99"]
    assert "'clip_g': (3, 20)" in run_port("sdxl_emb", *args, "--output", out_t)
    run_jax("sdxl_emb", *args, "--output", out_j)
    assert_files_equal(out_t, out_j)
