"""Image-quality metrics: PSNR (``metrics``; SSIM is ``train.loss.ssim``), LPIPS."""

from gsjax_torch.eval import lpips
from gsjax_torch.eval.metrics import mse, psnr

__all__ = ["lpips", "mse", "psnr"]
