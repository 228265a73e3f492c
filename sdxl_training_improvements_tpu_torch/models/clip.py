"""CLIP text encoders (CLIP-L and CLIP-G) in PyTorch.

Port of ``sdxl_training_improvements_tpu/models/clip.py``.  The encoding
contract: prompt embeds are the penultimate hidden states (not final-LN'd)
of both encoders, concatenated on the feature axis ([B, 77, 768 + 1280]);
the pooled embeds are CLIP-G's projected EOS state.  Attention here is
plain matmul + fp32 softmax, as in the JAX package (no kernel there
either).  Module names follow transformers' ``CLIPTextModel`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdxl_training_improvements_tpu_torch.models.layers import LayerNormF32


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: Optional[int] = None  # default 4*hidden
    hidden_act: str = "quick_gelu"  # quick_gelu | gelu
    projection_dim: Optional[int] = None  # set for the projected CLIP-G

    @classmethod
    def clip_l(cls) -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 text tower (SDXL text_encoder)."""
        return cls()

    @classmethod
    def clip_g(cls) -> "CLIPTextConfig":
        """OpenCLIP bigG text tower (SDXL text_encoder_2, projected)."""
        return cls(hidden_size=1280, num_layers=32, num_heads=20,
                   hidden_act="gelu", projection_dim=1280)

    @classmethod
    def tiny(cls, projection: bool = False) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=3, num_heads=4,
                   hidden_act="gelu", projection_dim=32 if projection else None)

    @property
    def mlp_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":  # exact erf GELU (transformers' "gelu")
        return F.gelu(x)
    raise ValueError(f"Unknown activation: {name}")


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask):
        b, s, d = x.shape
        hd = d // self.num_heads

        def heads(t):  # [B, S, D] -> [B, H, S, hd]
            return t.view(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * hd ** -0.5
        logits = logits.masked_fill(~mask, -1e9)  # -1e9, not -inf
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float())
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d).to(x.dtype))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNormF32(cfg.hidden_size)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = LayerNormF32(cfg.hidden_size)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNormF32(cfg.hidden_size)


class CLIPTextModel(nn.Module):
    """Returns a dict: ``hidden_states`` (embeddings + every layer's
    output), ``last_hidden_state`` (final-LN'd) and ``pooled_output``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size,
                                             cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        tm = self.text_model
        b, s = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) \
            + tm.embeddings.position_embedding.weight[None, :s]
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=input_ids.device).tril()
        hidden_states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            hidden_states.append(x)
        last = tm.final_layer_norm(x)
        # EOS pooling at the first maximal id: the EOS token is the
        # highest id, and padding repeats it after the true EOS
        eos = torch.argmax(input_ids, dim=-1)
        pooled = last[torch.arange(b, device=last.device), eos]
        if self.cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return {"hidden_states": hidden_states, "last_hidden_state": last,
                "pooled_output": pooled}


def encode_dual(clip_l: CLIPTextModel, clip_g: CLIPTextModel,
                input_ids_l: torch.Tensor, input_ids_g: torch.Tensor,
                clip_skip: int = 1):
    """Penultimate hidden states of both encoders, concatenated; pooled
    from CLIP-G.  ``clip_skip`` > 1 skips more layers."""
    out_l, out_g = clip_l(input_ids_l), clip_g(input_ids_g)
    idx = -(1 + clip_skip)
    return {"prompt_embeds": torch.cat(
                [out_l["hidden_states"][idx], out_g["hidden_states"][idx]],
                dim=-1),
            "pooled_prompt_embeds": out_g["pooled_output"]}


def encode_g(clip_g: CLIPTextModel, input_ids_g: torch.Tensor,
             clip_skip: int = 1):
    """CLIP-G-only conditioning (the SDXL refiner contract)."""
    out_g = clip_g(input_ids_g)
    return {"prompt_embeds": out_g["hidden_states"][-(1 + clip_skip)],
            "pooled_prompt_embeds": out_g["pooled_output"]}
