"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``."""

from repro_torch.configs.base import SHAPES, CodingConfig, ModelConfig, ShapeConfig, TrainConfig, cell_runnable

_ARCH_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "chatglm3-6b": "chatglm3_6b",
    "smollm-360m": "smollm_360m",
    "qwen2.5-14b": "qwen2_5_14b",
    "llama3.2-1b": "llama3_2_1b",
    "internvl2-2b": "internvl2_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCHS = tuple(_ARCH_MODULES)

# configs of the port alone: get_config resolves them, but they are not in
# ARCHS, whose dry-run cells are the JAX package's list
_PORT_ONLY = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def get_config(arch: str) -> ModelConfig:
    import importlib

    modules = {**_ARCH_MODULES, **_PORT_ONLY}
    if arch not in modules:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(modules)}")
    mod = importlib.import_module(f"repro_torch.configs.{modules[arch]}")
    return mod.CONFIG


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells that are runnable per DESIGN.md §5."""
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = cell_runnable(cfg, shape)
            if ok:
                cells.append((arch, shape.name))
    return cells


__all__ = [
    "ARCHS",
    "SHAPES",
    "CodingConfig",
    "ModelConfig",
    "ShapeConfig",
    "TrainConfig",
    "cell_runnable",
    "get_config",
    "runnable_cells",
]
