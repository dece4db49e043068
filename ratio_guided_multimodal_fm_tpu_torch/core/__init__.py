"""Device selection, precision policy and NaN guards."""
