"""Process-wide utilities: metrics and post-fork resets."""
