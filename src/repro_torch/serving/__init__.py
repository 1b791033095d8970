from repro_torch.serving.engine import ServeEngine, ServeRequest

__all__ = ["ServeEngine", "ServeRequest"]
