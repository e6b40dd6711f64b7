"""Command-line tools of the port, each run as ``python -m
lycoris_tpu_torch.tools.<name>`` (counterparts of the JAX package's
``tools/*.py``, with the same flags plus ``--device``, ``cuda`` by default):

- :mod:`.extract_locon` -- a LoCon from the difference of two checkpoints
  (batched SVD on the device);
- :mod:`.merge` -- an adapter file merged into a checkpoint;
- :mod:`.pack_bundle` -- embeddings packed into a LoRA file;
- :mod:`.batch_bundle_convert` -- bundles packed and unpacked by directory;
- :mod:`.batch_hcp_convert` -- HCP-diffusion <-> webui LoRA files;
- :mod:`.sdxl_emb` -- an SDXL embedding from token ids.

Files are read by ``wrapper.load_file_sd`` and written by
``utils/safetensors_io.py``: the package needs no ``safetensors``.
"""
