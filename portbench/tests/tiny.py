"""Toy versions of the cells, for the CPU tests: the cells' files with every
size cut, the limits and everything else as the cells state them."""
import copy

import torch

from portbench.lib import discover

CPU = torch.device("cpu")


def seamless() -> dict:
    c = copy.deepcopy(discover.config("seamless-m4t-large-v2"))
    c.update(hidden_size=64, encoder_layers=2, decoder_layers=2,
             encoder_attention_heads=4, decoder_attention_heads=4,
             num_key_value_heads=4, head_dim=16, encoder_ffn_dim=128,
             decoder_ffn_dim=128, vocab_size=512, frontend_dim=64)
    return c


def qwen() -> dict:
    c = copy.deepcopy(discover.config("qwen3-moe-235b-a22b-4l"))
    c.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, num_experts=8,
             num_experts_per_tok=2, moe_intermediate_size=32,
             vocab_size=512)
    c["program"]["set"]["moe.capacity_factor"] = 4.0
    c["serve"] = {"slots": 4, "max_len": 128, "block_size": 16, "chunk": 32}
    return c


def train_cell() -> dict:
    w = discover.workload("seamless-train-2k")
    w["traffic"].update(batch=4, seq=32, frames=32, grad_accum=2)
    return w


def chat_cell() -> dict:
    w = discover.workload("qwen3moe-serve-chat")
    w["traffic"].update(arrivals={"process": "poisson", "rate": 4.0},
                        prompt_len={"dist": "loguniform", "low": 8,
                                    "high": 64},
                        output_len={"dist": "uniform", "low": 4, "high": 16})
    w.update(drain_seconds=30, profile_seconds=1.0, check_tokens=40)
    return w


def fp32(config: dict) -> dict:
    """The configuration computed in float32: at toy sizes bfloat16's
    rounding says little of the cell's, so the tests that hold a toy run to
    a cell's limits run it in float32."""
    c = copy.deepcopy(config)
    c["program"].setdefault("set", {})["compute_dtype"] = "float32"
    for key in ("param_dtype", "compute_dtype", "torch_dtype"):
        if key in c:
            c[key] = "float32"
    return c


def context(cell: str, seed: int, seconds: float = 2.0, trace=False,
            exact=False):
    """A toy run's context; ``exact``: in float32."""
    from portbench.run import Context

    if cell == "train":
        name, work, config = "seamless-train-2k", train_cell(), seamless()
    else:
        name, work, config = "qwen3moe-serve-chat", chat_cell(), qwen()
    return Context(name, work, fp32(config) if exact else config, seed,
                   seconds, trace, CPU)
