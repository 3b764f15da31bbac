"""Configuration, stage timing and image saving."""
