"""Multiply-adds of the Nature torso, per sample."""

from __future__ import annotations


def layer_macs(cfg: dict) -> list:
    """``[conv0, conv1, conv2, fc0]`` multiply-adds a sample."""
    t = cfg["torso"]
    c_in, hw, out = t["stack"], t["frame"][0], []
    for c, k, s in t["conv"]:
        hw = (hw - k) // s + 1
        out.append(hw * hw * c * k * k * c_in)
        c_in = c
    out.append(c_in * hw * hw * t["fc"])
    return out


def macs(cfg: dict) -> int:
    return sum(layer_macs(cfg))


def first_layer_macs(cfg: dict) -> int:
    return layer_macs(cfg)[0]
