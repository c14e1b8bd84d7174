"""One index on one card: ``Retriever.build`` over the whole corpus at the
configuration's index build and query point (the local backend)."""

from __future__ import annotations


def query_point(cfg: dict):
    """The configuration's (StaticConfig, DynamicParams)."""
    from repro_torch.core.config import DynamicParams, StaticConfig

    q = cfg["query"]
    scfg = StaticConfig(variant=q["variant"], gamma=q["gamma"], gamma0=q["gamma0"], k_max=q["k"])
    return scfg, DynamicParams(k=q["k"], mu=q["mu"], eta=q["eta"], beta=q["beta"])


def build_retriever(cfg: dict, corpus_host, device):
    """The program under test: ``Retriever.build`` at the configuration's
    index build and query point."""
    from repro_torch.api import Retriever
    from repro_torch.index.builder import IndexBuildConfig

    ix = cfg["index"]
    build_cfg = IndexBuildConfig(b=ix["b"], c=ix["c"], bound_bits=ix["bound_bits"], doc_bits=ix["doc_bits"])
    scfg, params = query_point(cfg)
    return Retriever.build(corpus_host, scfg, build_cfg=build_cfg, params=params, device=device)


def port_leaves(index) -> dict:
    """The leaves of the program's index that the traversal reads, as plain
    tensors: what the check judges."""
    out = {"remap": index.doc_remap, "fwdq_tids": index.docs_fwdq.tids, "fwdq_ws": index.docs_fwdq.ws,
           "fwdq_scales": index.docs_fwdq.scales}
    for name, pb in (("blk", index.blk_bounds), ("sb", index.sb_bounds)):
        out.update({f"{name}_words": pb.packed, f"{name}_scale": pb.scale, f"{name}_bits": pb.bits,
                    f"{name}_granule": pb.granule_words})
    return out


def build(ctx, group):
    retr = build_retriever(ctx.cfg, ctx.host, ctx.device)
    group.built()
    return retr


def follow(ctx, group):
    raise ValueError("the local build serves one index on one card: a cell on several cards names its build")


def leaves(ctx, group) -> dict:
    return port_leaves(ctx.retr.index)
