"""Model towers: story UNet, fusion, VAE, CLIP text/vision, frame prior."""
