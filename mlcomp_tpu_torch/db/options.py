"""Pagination/sort options for providers (parity: reference db/core/options.py:1)."""


class PaginatorOptions:
    def __init__(self, page_number: int = 0, page_size: int = 100,
                 sort_column: str = None, sort_descending: bool = True):
        self.page_number = page_number or 0
        self.page_size = page_size or 100
        self.sort_column = sort_column
        self.sort_descending = sort_descending

    @classmethod
    def from_request(cls, data: dict):
        """The options of an API request (its ``paginator`` dict, or the
        request itself)."""
        paginator = data.get('paginator', data)
        return cls(
            page_number=paginator.get('page_number', 0),
            page_size=paginator.get('page_size', 100),
            sort_column=paginator.get('sort_column'),
            sort_descending=paginator.get('sort_descending', True),
        )

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
