from repro_torch.tasks.builder import combine_decisions

__all__ = ["combine_decisions"]
