"""Weight import/export and PNG files."""
