"""Tensor ops on channels-last (B, T, H, W, C) video tensors."""
