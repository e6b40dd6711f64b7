"""Named presets of the port: a copy of ``lycoris_tpu/config.py`` (same schema
and content as reference lycoris/config.py:1-196), kept here so that the port
never imports the JAX package. A test holds the two tables equal.

Keys per preset (validated against VALID_PRESET_KEYS in wrapper.py):
``enable_conv, target_module, target_name, module_algo_map, name_algo_map,
lora_prefix, use_fnmatch, unet_target_module, unet_target_name,
text_encoder_target_module, text_encoder_target_name, exclude_name``.

The ``unet_*`` / ``text_encoder_*`` keys drive the kohya dual-tree wrapper;
the standalone wrapper reads ``target_module`` / ``target_name``. Class-name
lists cover diffusers UNets, DiT families (Flux, SD3.5, HunYuan, Wan,
Lumina-2, Qwen, FramePack) and CLIP/T5/Gemma text encoders, plus the class
names used by lycoris_tpu_torch.models.
"""

_DIT_BLOCKS = [
    "HunYuanDiTBlock",  # HunYuanDiT
    "DoubleStreamBlock",  # Flux
    "SingleStreamBlock",  # Flux
    "SingleDiTBlock",  # SD3.5
    "MMDoubleStreamBlock",  # HunYuanVideo
    "MMSingleStreamBlock",  # HunYuanVideo
    "WanAttentionBlock",  # Wan
    "HunyuanVideoTransformerBlock",  # FramePack
    "HunyuanVideoSingleTransformerBlock",  # FramePack
    "JointTransformerBlock",  # lumina-image-2
    "FinalLayer",  # lumina-image-2
    "QwenImageTransformerBlock",  # Qwen
]

_TE_MODULES = [
    "CLIPAttention",
    "CLIPSdpaAttention",
    "CLIPMLP",
    "MT5Block",
    "BertLayer",
    "Gemma2Attention",
    "Gemma2FlashAttention2",
    "Gemma2SdpaAttention",
    "Gemma2MLP",
]

PRESET = {
    "full": {
        "enable_conv": True,
        "unet_target_module": [
            "Transformer2DModel",
            "ResnetBlock2D",
            "Downsample2D",
            "Upsample2D",
            *_DIT_BLOCKS,
        ],
        "unet_target_name": [
            "conv_in",
            "conv_out",
            "time_embedding.linear_1",
            "time_embedding.linear_2",
        ],
        "text_encoder_target_module": list(_TE_MODULES),
        "text_encoder_target_name": [],
    },
    "full-lin": {
        "enable_conv": False,
        "unet_target_module": ["Transformer2DModel", "ResnetBlock2D", *_DIT_BLOCKS],
        "unet_target_name": [
            "time_embedding.linear_1",
            "time_embedding.linear_2",
        ],
        "text_encoder_target_module": list(_TE_MODULES),
        "text_encoder_target_name": [],
    },
    "attn-mlp": {
        "enable_conv": False,
        "unet_target_module": ["Transformer2DModel", *_DIT_BLOCKS],
        "unet_target_name": [],
        "text_encoder_target_module": list(_TE_MODULES),
        "text_encoder_target_name": [],
    },
    "attn-only": {
        "enable_conv": False,
        "unet_target_module": ["CrossAttention", "SelfAttention"],
        "unet_target_name": [],
        "text_encoder_target_module": [
            "CLIPAttention",
            "CLIPSdpaAttention",
            "BertAttention",
            "MT5LayerSelfAttention",
            "Gemma2Attention",
            "Gemma2FlashAttention2",
            "Gemma2SdpaAttention",
        ],
        "text_encoder_target_name": [],
    },
    "unet-only": {
        "enable_conv": True,
        "unet_target_module": [
            "Transformer2DModel",
            "ResnetBlock2D",
            "Downsample2D",
            "Upsample2D",
            *_DIT_BLOCKS,
        ],
        "unet_target_name": [
            "conv_in",
            "conv_out",
            "time_embedding.linear_1",
            "time_embedding.linear_2",
        ],
        "text_encoder_target_module": [],
        "text_encoder_target_name": [],
    },
    "unet-transformer-only": {
        "enable_conv": False,
        "unet_target_module": ["Transformer2DModel", *_DIT_BLOCKS],
        "unet_target_name": [],
        "text_encoder_target_module": [],
        "text_encoder_target_name": [],
    },
    "unet-convblock-only": {
        "enable_conv": True,
        "unet_target_module": ["ResnetBlock2D", "Downsample2D", "Upsample2D"],
        "unet_target_name": ["conv_in", "conv_out"],
        "text_encoder_target_module": [],
        "text_encoder_target_name": [],
    },
    "ia3": {
        "enable_conv": False,
        "unet_target_module": [],
        "unet_target_name": ["to_k", "to_v", "ff.net.2"],
        "text_encoder_target_module": [],
        "text_encoder_target_name": ["k_proj", "v_proj", "mlp.fc2"],
        "name_algo_map": {
            "mlp.fc2": {"train_on_input": True},
            "ff.net.2": {"train_on_input": True},
        },
    },
}
