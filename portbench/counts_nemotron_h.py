"""The operations and bytes of NVIDIA-Nemotron-3-Nano (``nemotron_h``),
computed from its configuration's shapes alone (the published config.json's
key names); nothing here reads the program.

A layer is one block of the pattern ``hybrid_override_pattern``: ``M`` a
Mamba-2 mixer, ``*`` GQA attention, ``E`` a MoE of ``num_experts_per_tok``
routed experts out of ``n_routed_experts`` plus one shared expert (experts
``down(relu(up(x))^2)``, no gate), ``-`` a dense MLP of the same form. The
head is untied. Operations count two per multiply-add of the products a
token meets; elementwise work, norms and the router's sort are left out, and
so are attention's two products over the context (QK and PV, which grow with
the position: ~1% of a token's operations at the serving cell's contexts).
"""

from __future__ import annotations

import dataclasses

from portbench.counts import PEAK_BF16_FLOPS, seconds_at_hbm

BF16, F32 = 2, 4


@dataclasses.dataclass(frozen=True)
class NemotronH:
    hidden_size: int
    num_hidden_layers: int
    vocab_size: int
    pattern: str
    mamba_num_heads: int
    mamba_head_dim: int
    n_groups: int
    ssm_state_size: int
    conv_kernel: int
    chunk_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    n_routed_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    moe_shared_expert_intermediate_size: int
    intermediate_size: int

    @classmethod
    def from_config(cls, cfg: dict) -> "NemotronH":
        keys = [f.name for f in dataclasses.fields(cls) if f.name != "pattern"]
        return cls(pattern=cfg["hybrid_override_pattern"], **{k: int(cfg[k]) for k in keys})

    # -- shapes ------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.ssm_state_size

    def kinds(self) -> str:
        """The pattern character of every layer, in order."""
        p = self.pattern
        return "".join(p[i % len(p)] for i in range(self.num_hidden_layers))

    def count(self, kind: str) -> int:
        return self.kinds().count(kind)

    # -- parameters ----------------------------------------------------------
    def mamba_matmul_params(self) -> int:
        D, di, GN = self.hidden_size, self.d_inner, self.n_groups * self.ssm_state_size
        return D * (2 * di + 2 * GN + self.mamba_num_heads) + di * D

    def mamba_params(self) -> int:
        """Products, conv taps and biases, A, D and the dt bias per head, the
        gated norm."""
        return (self.mamba_matmul_params() + self.conv_kernel * self.conv_dim + self.conv_dim
                + 3 * self.mamba_num_heads + self.d_inner)

    def attn_params(self) -> int:
        D, H, KV, hd = (self.hidden_size, self.num_attention_heads, self.num_key_value_heads,
                        self.head_dim)
        return 2 * D * H * hd + 2 * D * KV * hd

    def expert_params(self, width: int) -> int:
        return 2 * self.hidden_size * width

    def router_params(self) -> int:
        """The router's product and its selection bias."""
        return self.hidden_size * self.n_routed_experts + self.n_routed_experts

    def moe_params(self) -> int:
        return (self.router_params()
                + self.n_routed_experts * self.expert_params(self.moe_intermediate_size)
                + self.expert_params(self.moe_shared_expert_intermediate_size))

    def layer_params(self, kind: str) -> int:
        """One layer of ``kind``, its pre-norm included."""
        body = {"M": self.mamba_params, "*": self.attn_params, "E": self.moe_params,
                "-": lambda: self.expert_params(self.intermediate_size)}[kind]
        return body() + self.hidden_size

    def params(self) -> int:
        """Embedding and untied head, every layer, the final norm."""
        return (2 * self.vocab_size * self.hidden_size
                + sum(self.layer_params(k) for k in self.kinds()) + self.hidden_size)

    # -- operations per token ----------------------------------------------
    def ssd_chunked_flops(self) -> float:
        """One token's share of the chunked SSD scan in one layer (as
        ``counts.Mamba2``): C.B in its chunk per group, the weighted sum of x
        per head over the causal half of the chunk, its chunk-state term and
        its read of the carried state."""
        Q, N, P = self.chunk_size, self.ssm_state_size, self.mamba_head_dim
        pairs = (Q + 1) / 2
        H = self.mamba_num_heads
        return self.n_groups * 2 * N * pairs + H * 2 * P * pairs + H * 4 * N * P

    def ssd_recurrent_flops(self) -> float:
        return self.mamba_num_heads * 4 * self.ssm_state_size * self.mamba_head_dim

    def routed_flops(self) -> float:
        """The router and the experts a token meets in one MoE layer."""
        return 2 * (self.hidden_size * self.n_routed_experts
                    + self.num_experts_per_tok * self.expert_params(self.moe_intermediate_size)
                    + self.expert_params(self.moe_shared_expert_intermediate_size))

    def layer_flops(self, kind: str, recurrent: bool) -> float:
        if kind == "M":
            ssd = self.ssd_recurrent_flops() if recurrent else self.ssd_chunked_flops()
            return 2 * self.mamba_matmul_params() + 2 * self.conv_kernel * self.conv_dim + ssd
        if kind == "*":
            return 2 * self.attn_params()
        if kind == "E":
            return self.routed_flops()
        return 2 * self.expert_params(self.intermediate_size)

    def head_flops(self) -> float:
        return 2 * self.hidden_size * self.vocab_size

    def prompt_flops_per_token(self) -> float:
        """A prompt token through every layer; the head only runs for the
        tokens that are generated."""
        return sum(self.layer_flops(k, False) for k in self.kinds())

    def generated_flops(self, from_decode: bool) -> float:
        """One generated token: its head, plus a decode step through every
        layer for the tokens after a request's first."""
        layers = sum(self.layer_flops(k, True) for k in self.kinds()) if from_decode else 0.0
        return layers + self.head_flops()

    # -- bytes ----------------------------------------------------------------
    def moe_call_least_bytes(self, hit: float, tokens: float) -> float:
        """The least one MoE layer's call moves: each of the ``hit`` experts
        the call's tokens chose read once (bf16), the shared expert once, the
        float32 router and its bias once, the ``tokens`` rows read and the
        output written once (bf16)."""
        D = self.hidden_size
        return (hit * self.expert_params(self.moe_intermediate_size) * BF16
                + self.expert_params(self.moe_shared_expert_intermediate_size) * BF16
                + self.router_params() * F32 + 2 * tokens * D * BF16)

    def routed_least_s(self, hit: float, assignments: float) -> float:
        """The least time of one MoE call's routed experts, both grouped
        products: the ``hit`` experts read once (bf16) and the
        ``assignments`` rows read and written once (bf16) at 3.35 TB/s, or
        their operations at 989 TFLOP/s, whichever is longer."""
        F = self.moe_intermediate_size
        nbytes = hit * self.expert_params(F) * BF16 + 2 * assignments * self.hidden_size * BF16
        flops = 2 * assignments * self.expert_params(F)
        return max(seconds_at_hbm(nbytes), flops / PEAK_BF16_FLOPS)

    def expected_hit(self, tokens: int) -> float:
        """Experts hit by ``tokens`` tokens under even, independent routing."""
        E, K = self.n_routed_experts, self.num_experts_per_tok
        return E * (1.0 - (1.0 - K / E) ** tokens)
