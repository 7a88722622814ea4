"""Host-side data layer (numpy, PIL, pandas): evaluation subset."""
