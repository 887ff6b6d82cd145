"""Recursive-descent parser for the SQL front door (DESIGN.md §13).

Grammar (one SELECT statement, no subqueries)::

    query      := SELECT select_list FROM table_ref join* where?
                  group? order? limit?
    select_list:= '*' | item (',' item)*
    item       := ident '.' '*' | expr ((AS)? ident)?
    table_ref  := ident ((AS)? ident)?
    join       := ((INNER | LEFT (OUTER)?))? JOIN table_ref ON on_cond
    on_cond    := col_eq (AND col_eq)*
    col_eq     := colref '=' colref
    where      := WHERE expr
    group      := GROUP BY colref (',' colref)*
    order      := ORDER BY colref (ASC|DESC)? (',' ...)*
    limit      := LIMIT INT
    expr       := or ; or := and (OR and)* ; and := not (AND not)*
    not        := NOT not | cmp
    cmp        := add (cmpop add)? | add IS (NOT)? NULL
    cmpop      := '=' | '==' | '!=' | '<>' | '<' | '<=' | '>' | '>='
    add        := mul (('+'|'-') mul)*
    mul        := unary (('*'|'/') unary)*
    unary      := '-' unary | primary
    primary    := literal | aggcall | colref | '(' expr ')'
    aggcall    := (SUM|COUNT|MIN|MAX|MEAN|AVG) '(' expr ')'
    colref     := ident ('.' ident)?
    literal    := INT | FLOAT | STRING | TRUE | FALSE | NULL

ON conditions are restricted to conjunctions of column equalities —
that is exactly what the logical ``Join`` op (and every backend hash
join) supports, so the restriction is honest rather than a parser
shortcut. ``AVG`` is accepted as a synonym for ``MEAN``.
"""
from __future__ import annotations

from repro_torch.sql import ast as A
from repro_torch.sql.errors import SqlParseError
from repro_torch.sql.tokens import Token, tokenize

__all__ = ["parse"]

_AGG_FNS = {"SUM": "sum", "COUNT": "count", "MIN": "min",
            "MAX": "max", "MEAN": "mean", "AVG": "mean"}
_CMP_OPS = {"=": "=", "==": "=", "!=": "!=", "<>": "!=",
            "<": "<", "<=": "<=", ">": ">", ">=": ">="}


class _Parser:
    def __init__(self, query: str):
        self.query = query
        self.toks = tokenize(query)
        self.i = 0

    # -- token plumbing -------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "KEYWORD" and self.cur.text in kws

    def take_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            self.fail(f"expected {kw}")
        return self.advance()

    def at(self, kind: str, text: str | None = None) -> bool:
        return (self.cur.kind == kind
                and (text is None or self.cur.text == text))

    def take(self, kind: str, text: str | None = None) -> bool:
        if self.at(kind, text):
            self.advance()
            return True
        return False

    def expect(self, kind: str, text: str | None = None,
               what: str | None = None) -> Token:
        if not self.at(kind, text):
            self.fail(f"expected {what or text or kind}")
        return self.advance()

    def fail(self, what: str):
        t = self.cur
        got = "end of query" if t.kind == "EOF" else repr(t.text)
        raise SqlParseError(
            f"syntax error at position {t.pos}: {what}, got {got}")

    def ident(self, what: str = "identifier") -> Token:
        if self.cur.kind != "IDENT":
            self.fail(f"expected {what}")
        return self.advance()

    # -- productions ----------------------------------------------------
    def parse(self) -> A.Query:
        self.expect_kw("SELECT")
        items = self.select_list()
        self.expect_kw("FROM")
        from_table = self.table_ref()
        joins = []
        while self.at_kw("JOIN", "INNER", "LEFT"):
            joins.append(self.join_clause())
        where = None
        if self.take_kw("WHERE"):
            where = self.expr()
        group_by: tuple[A.ColumnRef, ...] = ()
        if self.at_kw("GROUP"):
            self.advance()
            self.expect_kw("BY")
            group_by = tuple(self.colref_list())
        order_by: list[A.OrderItem] = []
        if self.at_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            while True:
                ref = self.colref()
                asc = True
                if self.take_kw("DESC"):
                    asc = False
                else:
                    self.take_kw("ASC")
                order_by.append(A.OrderItem(ref, asc, ref.pos))
                if not self.take("PUNCT", ","):
                    break
        limit = None
        if self.take_kw("LIMIT"):
            tok = self.expect("INT", what="an integer LIMIT")
            limit = int(tok.text)
        if self.cur.kind != "EOF":
            self.fail("expected end of query")
        return A.Query(items=tuple(items), from_table=from_table,
                       joins=tuple(joins), where=where,
                       group_by=group_by, order_by=tuple(order_by),
                       limit=limit)

    def select_list(self) -> list[A.SelectItem]:
        items = []
        while True:
            pos = self.cur.pos
            if self.take("OP", "*"):
                items.append(A.SelectItem(A.Star(None, pos), None, pos))
            elif (self.cur.kind == "IDENT"
                  and self.toks[self.i + 1].kind == "PUNCT"
                  and self.toks[self.i + 1].text == "."
                  and self.toks[self.i + 2].kind == "OP"
                  and self.toks[self.i + 2].text == "*"):
                qual = self.advance().text
                self.advance()          # '.'
                self.advance()          # '*'
                items.append(A.SelectItem(A.Star(qual, pos), None, pos))
            else:
                e = self.expr()
                alias = None
                if self.take_kw("AS"):
                    alias = self.ident("output name after AS").text
                elif self.cur.kind == "IDENT":
                    alias = self.advance().text
                items.append(A.SelectItem(e, alias, pos))
            if not self.take("PUNCT", ","):
                return items

    def table_ref(self) -> A.TableRef:
        name = self.ident("table name")
        alias = None
        if self.take_kw("AS"):
            alias = self.ident("table alias after AS").text
        elif self.cur.kind == "IDENT":
            alias = self.advance().text
        return A.TableRef(name.text, alias, name.pos)

    def join_clause(self) -> A.JoinClause:
        pos = self.cur.pos
        how = "inner"
        if self.take_kw("LEFT"):
            how = "left"
            self.take_kw("OUTER")
        else:
            self.take_kw("INNER")
        self.expect_kw("JOIN")
        table = self.table_ref()
        self.expect_kw("ON")
        conds = [self.col_eq()]
        while self.take_kw("AND"):
            conds.append(self.col_eq())
        return A.JoinClause(table, how, tuple(conds), pos)

    def col_eq(self) -> tuple[A.ColumnRef, A.ColumnRef]:
        left = self.colref("a join key column")
        self.expect("OP", "=", "'=' between join key columns")
        right = self.colref("a join key column")
        return left, right

    def colref(self, what: str = "a column reference") -> A.ColumnRef:
        tok = self.ident(what)
        if self.at("PUNCT", "."):
            self.advance()
            name = self.ident("column name after '.'")
            return A.ColumnRef(tok.text, name.text, tok.pos)
        return A.ColumnRef(None, tok.text, tok.pos)

    def colref_list(self) -> list[A.ColumnRef]:
        refs = [self.colref()]
        while self.take("PUNCT", ","):
            refs.append(self.colref())
        return refs

    # expression precedence ladder
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.at_kw("OR"):
            pos = self.advance().pos
            left = A.BinOp("OR", left, self.and_expr(), pos)
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.at_kw("AND"):
            pos = self.advance().pos
            left = A.BinOp("AND", left, self.not_expr(), pos)
        return left

    def not_expr(self):
        if self.at_kw("NOT"):
            pos = self.advance().pos
            return A.UnaryOp("NOT", self.not_expr(), pos)
        return self.cmp_expr()

    def cmp_expr(self):
        left = self.add_expr()
        if self.at_kw("IS"):
            pos = self.advance().pos
            negated = bool(self.take_kw("NOT"))
            self.expect_kw("NULL")
            return A.IsNull(left, negated, pos)
        if self.cur.kind == "OP" and self.cur.text in _CMP_OPS:
            tok = self.advance()
            return A.BinOp(_CMP_OPS[tok.text], left, self.add_expr(),
                           tok.pos)
        return left

    def add_expr(self):
        left = self.mul_expr()
        while self.at("OP", "+") or self.at("OP", "-"):
            tok = self.advance()
            left = A.BinOp(tok.text, left, self.mul_expr(), tok.pos)
        return left

    def mul_expr(self):
        left = self.unary()
        while self.at("OP", "*") or self.at("OP", "/"):
            tok = self.advance()
            left = A.BinOp(tok.text, left, self.unary(), tok.pos)
        return left

    def unary(self):
        if self.at("OP", "-"):
            pos = self.advance().pos
            return A.UnaryOp("-", self.unary(), pos)
        return self.primary()

    def primary(self):
        t = self.cur
        if t.kind == "INT":
            self.advance()
            return A.Literal(int(t.text), t.pos)
        if t.kind == "FLOAT":
            self.advance()
            return A.Literal(float(t.text), t.pos)
        if t.kind == "STRING":
            self.advance()
            return A.Literal(t.text, t.pos)
        if t.kind == "KEYWORD":
            if t.text in ("TRUE", "FALSE"):
                self.advance()
                return A.Literal(t.text == "TRUE", t.pos)
            if t.text == "NULL":
                self.advance()
                return A.Literal(None, t.pos)
            if t.text in _AGG_FNS:
                self.advance()
                self.expect("PUNCT", "(")
                if t.text == "COUNT" and self.at("OP", "*"):
                    self.fail("COUNT(*) is not supported; "
                              "COUNT a column instead")
                arg = self.expr()
                self.expect("PUNCT", ")")
                return A.AggCall(_AGG_FNS[t.text], arg, t.pos)
            self.fail("expected an expression")
        if t.kind == "IDENT":
            return self.colref()
        if self.take("PUNCT", "("):
            e = self.expr()
            self.expect("PUNCT", ")")
            return e
        self.fail("expected an expression")


def parse(query: str) -> A.Query:
    """Parse one SELECT statement into a :class:`repro_torch.sql.ast.Query`."""
    if not query or not query.strip():
        raise SqlParseError("empty query")
    return _Parser(query).parse()
