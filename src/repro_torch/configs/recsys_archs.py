"""The four assigned recsys architectures (exact public configs), as data
— the port's copy of ``repro.configs.recsys_archs``."""

from __future__ import annotations

from ..models.recsys import RecSysConfig, default_vocab_sizes
from .registry import RecsysArch, register


@register("wide-deep")
def wide_deep() -> RecsysArch:
    # [arXiv:1606.07792] 40 sparse fields, embed 32, MLP 1024-512-256, concat
    cfg = RecSysConfig(
        name="wide-deep", interaction="concat", n_dense=13, n_sparse=40,
        embed_dim=32, vocab_sizes=default_vocab_sizes(40),
        mlp_dims=(1024, 512, 256))
    return RecsysArch("wide-deep", cfg)


@register("xdeepfm")
def xdeepfm() -> RecsysArch:
    # [arXiv:1803.05170] 39 sparse, embed 10, CIN 200-200-200, MLP 400-400
    cfg = RecSysConfig(
        name="xdeepfm", interaction="cin", n_dense=13, n_sparse=39,
        embed_dim=10, vocab_sizes=default_vocab_sizes(39),
        mlp_dims=(400, 400), cin_dims=(200, 200, 200))
    return RecsysArch("xdeepfm", cfg)


@register("dlrm-rm2")
def dlrm_rm2() -> RecsysArch:
    # [arXiv:1906.00091] RM2: 13 dense, 26 sparse, embed 64,
    # bot 13-512-256-64, top 512-512-256-1, dot interaction
    cfg = RecSysConfig(
        name="dlrm-rm2", interaction="dot", n_dense=13, n_sparse=26,
        embed_dim=64, vocab_sizes=default_vocab_sizes(26),
        bot_mlp_dims=(512, 256, 64), mlp_dims=(512, 512, 256, 1))
    return RecsysArch("dlrm-rm2", cfg)


@register("dcn-v2")
def dcn_v2() -> RecsysArch:
    # [arXiv:2008.13535] 13 dense, 26 sparse, embed 16, 3 cross layers,
    # MLP 1024-1024-512
    cfg = RecSysConfig(
        name="dcn-v2", interaction="cross", n_dense=13, n_sparse=26,
        embed_dim=16, vocab_sizes=default_vocab_sizes(26),
        mlp_dims=(1024, 1024, 512), n_cross_layers=3)
    return RecsysArch("dcn-v2", cfg)
