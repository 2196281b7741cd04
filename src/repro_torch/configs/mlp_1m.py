"""1.2M-parameter feed-forward network — the paper's accuracy-parity workload.

Used by the exactness benchmark/tests: shard-parallel training of this model
must match single-device training bit-for-bit in math (paper desideratum D3).
Layout: 784 -> 512 -> 512 -> 512 -> 10  (~1.19M params, matching the paper's
"1.2 million parameter feedforward neural network").
"""
import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str = "mlp-1m"
    family: str = "mlp"
    d_in: int = 784
    d_hidden: int = 512
    n_hidden: int = 3
    d_out: int = 10

    def param_count(self) -> int:
        # input projection + n_hidden residual-width layers + head ≈ 1.195M
        n = self.d_in * self.d_hidden + self.d_hidden
        for _ in range(self.n_hidden):
            n += self.d_hidden * self.d_hidden + self.d_hidden
        n += self.d_hidden * self.d_out + self.d_out
        return n


CONFIG = MLPConfig()

# ArchConfig view so the registry stays uniform (treated as 'mlp' family).
ARCH_VIEW = ArchConfig(
    name="mlp-1m", family="mlp", n_layers=4, d_model=512, n_heads=0,
    n_kv_heads=0, d_ff=512, vocab_size=0, rope="none",
    source="paper §4 workload",
)
