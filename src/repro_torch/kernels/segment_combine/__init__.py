from repro_torch.kernels.segment_combine.ops import segment_combine

__all__ = ["segment_combine"]
