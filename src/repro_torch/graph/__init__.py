"""Graph analytics on the port: chained SpGEMM with exact feed-forward
sizing, masked and fused multiplies, and seeded graph generators.

PyTorch port of ``repro.graph``, with the same names.
"""
from .algorithms import (MCLResult, k_hop_frontier, lower_triangle,
                         markov_cluster, seeds_to_frontier, triangle_count)
from .chain import (ChainResult, ChainRunner, ChainStats, SizeFeed,
                    spgemm_chain, structure_hash)
from .generators import erdos_renyi_csr, rmat_csr
from .ops import (bool_post, inflate, inflate_post, mask_post,
                  masked_spgemm, normalize_columns, prune, spgemm_mask)

__all__ = [
    "ChainResult", "ChainRunner", "ChainStats", "MCLResult", "SizeFeed",
    "bool_post", "erdos_renyi_csr", "inflate", "inflate_post",
    "k_hop_frontier", "lower_triangle", "markov_cluster", "mask_post",
    "masked_spgemm", "normalize_columns", "prune", "rmat_csr",
    "seeds_to_frontier", "spgemm_chain", "spgemm_mask", "structure_hash",
    "triangle_count",
]
