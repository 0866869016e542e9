"""Pagination/sort options for providers (parity: reference db/core/options.py:1)."""


class PaginatorOptions:
    def __init__(self, page_number: int = 0, page_size: int = 100,
                 sort_column: str = None, sort_descending: bool = True):
        self.page_number = page_number or 0
        self.page_size = page_size or 100
        self.sort_column = sort_column
        self.sort_descending = sort_descending

    def sql(self, default_sort: str = 'id', allowed: set = None):
        col = self.sort_column or default_sort
        # identifier whitelist — sort_column comes from request payloads
        if not col.replace('_', '').isalnum():
            col = default_sort
        if allowed is not None and col not in allowed:
            col = default_sort
        direction = 'DESC' if self.sort_descending else 'ASC'
        offset = self.page_number * self.page_size
        return f'ORDER BY {col} {direction} LIMIT {self.page_size} ' \
               f'OFFSET {offset}'
