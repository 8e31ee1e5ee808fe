"""The model work an SD3 transition needs (work.py's counts of image evals
and keyframes): the MMDiT's evals and the keyframes' decodes for `mfu`;
the MMDiT's joint attention, every block at every needed image eval, and
the VAE's mid-block attention, with the port's kernels that run them, for
`attn_roofline`. T5 and the CLIP towers are not counted (as SDXL's CLIP).
"""
from __future__ import annotations

from benchmark.yardstick import flops, roofline, work

# the port's K2 (d=64; its whole-tile and tail instantiations alike) and K3
# (d=512) kernels, by the profiler's names of both templates
ATTENTION_KERNELS = ("attention_d64_", "attention_d512_")


def _tokens(cfg: dict) -> tuple[int, int, int]:
    """(image tokens, text tokens, hidden width) of one eval: the latent's
    patches; CLIP's 77 and T5's max_sequence_length; heads x head size."""
    t, run = cfg["transformer"], cfg["run"]
    p = t["patch_size"]
    lx = (run["height"] // 8 // p) * (run["width"] // 8 // p)
    lc = cfg["text_encoder"]["max_position_embeddings"] + run["max_sequence_length"]
    return lx, lc, t["num_attention_heads"] * t["attention_head_dim"]


def mmdit_forward_flops(cfg: dict, batch: int) -> float:
    """FLOPs (matmul MACs x 2) of one MMDiT forward for `batch` images: per
    block q/k/v, output and GELU MLP (4x) projections of both streams
    (24 L D²), the joint attention (4 L² D) and the adaLN linears; the last
    block's text stream only its q/k/v; the embedders and the output."""
    t = cfg["transformer"]
    lx, lc, d = _tokens(cfg)
    L = lx + lc
    ps, cin, cout = t["patch_size"], t["in_channels"], t["out_channels"]
    block = 24.0 * L * d * d + 4.0 * L * L * d + 2 * 2.0 * d * 6 * d
    last = 24.0 * lx * d * d + 6.0 * lc * d * d + 4.0 * L * L * d + 2.0 * d * 6 * d + 2.0 * d * 2 * d
    f = (t["num_layers"] - 1) * block + last
    f += 2.0 * lx * cin * ps * ps * d  # patch embed
    f += 2.0 * lc * t["joint_attention_dim"] * t["caption_projection_dim"]  # context embedder
    f += 2.0 * 256 * d + 2.0 * d * d + 2.0 * t["pooled_projection_dim"] * d + 2.0 * d * d  # time + text embed
    f += 2.0 * d * 2 * d + 2.0 * lx * d * ps * ps * cout  # norm_out, proj_out
    return f * batch


def model_seconds_at_peak(cfg: dict) -> float:
    """Seconds the needed MMDiT and decode work takes at the peak of each
    part's configured dtype."""
    run = cfg["run"]
    mm_f = mmdit_forward_flops(cfg, work.image_evals(cfg))
    vae_f = flops.vae_decode_flops(cfg["vae"], run["height"], run["width"], work.keyframes(cfg))
    return (mm_f / roofline.MODEL_PEAK[run["dtypes"]["mmdit"]]
            + vae_f / roofline.MODEL_PEAK[run["dtypes"]["vae"]])


def attention_bound_seconds(cfg: dict) -> float:
    """Bound of the attention-kernel work a transition needs: K2 at
    [image evals, L, heads, 64] in every block, and the VAE mid-block
    attention once per keyframe."""
    run, t = cfg["run"], cfg["transformer"]
    lx, lc, _ = _tokens(cfg)
    joint = t["num_layers"] * roofline.attention_bound_s(work.image_evals(cfg), lx + lc, t["num_attention_heads"],
                                                         t["attention_head_dim"], run["dtypes"]["mmdit"])
    return joint + roofline.vae_attention_bound_s(cfg["vae"], run["height"], run["width"], work.keyframes(cfg),
                                                  run["dtypes"]["vae"])
