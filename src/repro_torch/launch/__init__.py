"""Front ends that serve solve requests (the solve service)."""
