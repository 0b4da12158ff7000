from trivy_tpu_torch.native.loader import load_native

__all__ = ["load_native"]
