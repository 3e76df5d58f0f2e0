"""Model zoo: plain-function models over params dicts, assembled from LayerSpecs."""

from repro_torch.models.lm import Model, build_model, params_from_numpy

__all__ = ["Model", "build_model", "params_from_numpy"]
