from repro_torch.data.synthetic import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
