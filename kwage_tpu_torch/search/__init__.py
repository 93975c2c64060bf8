"""Host search engine, output rendering and device-resident search
serving of the port."""

from .engine import MatchResult, search_database, search_database_files
from .output import render_csv, render_json
