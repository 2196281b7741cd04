"""A model configuration file (``bench/configs/<name>.json``) read into
:class:`Sizes`, the plain description that the weights, the batches and
the reference share.

A configuration file holds the published ``config.json`` keys of its
source (with the keys listed in ``reduced`` changed), and a ``model``
block: the family, the literal settings the published keys do not carry,
and ``sizes``, which names for each size the published key it is read
from. Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

FAMILIES = ("decoder", "encoder")
PRECISIONS = ("float32",)


@dataclasses.dataclass(frozen=True)
class Sizes:
    name: str
    family: str  # "decoder" (causal, RMS norms, RoPE) or "encoder"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm_eps: float
    act: str  # "swiglu" or "gelu_tanh"
    rope: str  # "2d" (rotary on the first half of each head) or "learned"
    rope_theta: float = 10_000.0
    max_positions: int = 0  # rows of the learned position table
    precision: str = "float32"

    @property
    def causal(self) -> bool:
        return self.family == "decoder"


def load_config(path) -> dict:
    return json.loads(Path(path).read_text())


def sizes_of(config: dict) -> Sizes:
    """:class:`Sizes` from a configuration file's contents."""
    model = config["model"]
    if model["family"] not in FAMILIES:
        raise ValueError(f"unknown family {model['family']!r}")
    if config["precision"] not in PRECISIONS:
        raise ValueError(f"unknown precision {config['precision']!r}")
    fields = {f: config[key] for f, key in model["sizes"].items()}
    literal = {k: v for k, v in model.items() if k not in ("sizes",)}
    return Sizes(name=config["name"], precision=config["precision"],
                 **literal, **fields)


def stage_layers(sizes: Sizes, n_stages: int) -> int:
    """Layers a stage holds: the stack is padded to a multiple of the
    stages with no-op layers, as the program pads it."""
    return -(-sizes.n_layers // n_stages)


def padded_vocab(sizes: Sizes, n_stages: int) -> int:
    """The vocabulary padded to a multiple of the stages (the program's
    vocab-parallel embedding and head); padded rows are zero."""
    return -(-sizes.vocab_size // n_stages) * n_stages
