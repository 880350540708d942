"""sgrapp: the paper's own workload as cells: windowed exact counting (K1
on one device, the ring Gram over 'model' and the windows over 'data' on a
mesh) and the full sGrapp-x estimator scan."""
from .registry import Arch, register, sgrapp_cells
from .shapes import SGRAPP_SHAPES


def full_config() -> dict:
    return {"name": "sgrapp", "shapes": dict(SGRAPP_SHAPES)}


def smoke_config() -> dict:
    return {"name": "sgrapp",
            "shapes": {"win_8k": (4, 256, 128, 256),
                       "estimator": (8, 256, 128, 256)}}


register(Arch("sgrapp", "stream", full_config, smoke_config, sgrapp_cells))
