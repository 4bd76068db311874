"""The WMS server's host render: colour maps without matplotlib."""
