"""The student network: VGG-11 backbone, MLP heads, shared building blocks."""
