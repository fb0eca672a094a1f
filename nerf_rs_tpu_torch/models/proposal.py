"""The proposal density MLP (mip-NeRF 360 lineage), the counterpart of
``nerf_rs_tpu/models/proposal.py``: a small net whose only job is to
predict where density is, so that the main field spends its samples
there.

    PE(x), L = pos_enc_levels -> depth x width ReLU -> sigma (1), relu

No view directions, no rgb head, no skip. The layers are ``Dense`` under
the JAX leaf names (``trunk.{i}``, ``sigma``), so a JAX proposal tree
converts with ``convert.params_from_numpy`` like a field's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ProposalConfig

from .encoding import posenc, posenc_dim
from .mlp import Dense, dense, he_init_, seed_rng

# numpy stream of the proposal net's draw (stream 0 is the main field's,
# stream 1 the hierarchical fine field's)
PROPOSAL_STREAM = 2


class ProposalMLP(nn.Module):
    """Parameters of the proposal net; ``forward`` is ``apply_proposal``."""

    def __init__(self, pcfg: ProposalConfig, device=None):
        super().__init__()
        self.pcfg = pcfg
        in_dim = posenc_dim(3, pcfg.pos_enc_levels, True)
        trunk = []
        for _ in range(pcfg.net_depth):
            trunk.append(Dense(in_dim, pcfg.net_width, device))
            in_dim = pcfg.net_width
        self.trunk = nn.ModuleList(trunk)
        self.sigma = Dense(pcfg.net_width, 1, device)

    def forward(self, points, dtype=None, contract: bool = False):
        return apply_proposal(self, points, self.pcfg, dtype, contract)


def init_proposal_params(pcfg: ProposalConfig, seed: int = 0, device=None) -> ProposalMLP:
    """A proposal net with He truncated-normal weights and zero biases
    (``mlp.he_init_``), drawn with numpy from ``seed`` on the stream
    ``PROPOSAL_STREAM``: the same weights on every device and torch
    version."""
    model = ProposalMLP(pcfg)
    he_init_(model, seed_rng(seed, PROPOSAL_STREAM))
    return model.to(device)


def apply_proposal(params: ProposalMLP, points: torch.Tensor, pcfg: ProposalConfig,
                   dtype=None, contract: bool = False) -> torch.Tensor:
    """Density at world ``points`` (..., 3) -> sigma (...,), relu'd f32.
    ``contract``: the points go through the main field's contraction
    first (the two nets share the coordinate chart). With a bf16
    ``dtype`` every layer runs in bf16, as ``apply_nerf``'s do."""
    if contract:
        from ..ops.contract import contract as contract_points

        points = contract_points(points)
    x = posenc(points, pcfg.pos_enc_levels, True)
    if dtype is not None and dtype != torch.float32:
        x = x.to(dtype)
    h = x
    for layer in params.trunk:
        h = F.relu(dense(h, layer, dtype))
    return F.relu(dense(h, params.sigma, dtype)[..., 0].float())
