"""`.m` model and `.t` tokenizer file formats."""
