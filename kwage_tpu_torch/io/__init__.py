from .binary import BinaryReader, BinaryWriter
from .bloom_file import (
    BLOOM_MAGIC_COMPLETE,
    BLOOM_MAGIC_IN_PROGRESS,
    BloomFilterRecord,
    read_bloom_file,
    write_bloom_file,
)
from .db_file import (
    CURRENT_DBFILE_VERSION,
    KWAGE_MAGIC_NUMBER,
    NO_COMPRESSION,
    DBFileHeader,
    DBFileReader,
    write_db_file,
)
from .status import read_status_file, write_status_file
from .inventory import read_inventory, write_inventory, scan_inventory_locations
from .sequence import SequenceIterator, iter_sequences
