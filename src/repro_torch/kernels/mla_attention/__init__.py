"""Paged absorbed latent attention: kernel, wrapper and plain version."""
