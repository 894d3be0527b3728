"""Show-o2 (Qwen2.5 + SigLIP + DiT head + Wan2.1 VAE) in PyTorch."""
