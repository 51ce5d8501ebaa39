"""Host-side data and morphology helpers of the port."""
