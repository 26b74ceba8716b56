// foamdict — OpenFOAM dictionary parser (native component).
//
// The reference framework is driven entirely by OpenFOAM dictionaries
// (SURVEY.md §2.5: system/controlDict, system/fvSchemes with the fvsc
// sub-dict, constant/thermophysicalProperties with the QGD sub-dict, field
// files with boundaryField entries).  This native parser lets users of the
// reference bring their case directories to this framework unchanged:
// it tokenizes the OpenFOAM dictionary grammar (C/C++ comments, #include-
// style directives skipped, nested {} dictionaries, () lists, [] dimension
// sets, ';'-terminated entries) and emits JSON consumed by
// qgdsolver_tpu.core.config.
//
// Exported C ABI:
//   char* foamdict_parse_json(const char* text)  -- malloc'd JSON (or an
//       {"error": ...} object); free with foamdict_free.
//   void  foamdict_free(char* p)
//
// Build: g++ -O2 -shared -fPIC -o libfoamdict.so foamdict.cpp
#include <cctype>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tok {
    enum Kind { WORD, NUM, STR, LBRACE, RBRACE, LPAREN, RPAREN, LBRACK,
                RBRACK, SEMI } kind;
    std::string text;
    double num = 0.0;
};

class Lexer {
  public:
    explicit Lexer(const char* s) : p_(s) {}

    bool next(Tok& t) {
        skip_ws_comments();
        if (!*p_) return false;
        char c = *p_;
        switch (c) {
            case '{': t = {Tok::LBRACE, "{"}; ++p_; return true;
            case '}': t = {Tok::RBRACE, "}"}; ++p_; return true;
            case '(': t = {Tok::LPAREN, "("}; ++p_; return true;
            case ')': t = {Tok::RPAREN, ")"}; ++p_; return true;
            case '[': t = {Tok::LBRACK, "["}; ++p_; return true;
            case ']': t = {Tok::RBRACK, "]"}; ++p_; return true;
            case ';': t = {Tok::SEMI, ";"}; ++p_; return true;
            case '"': return lex_string(t);
            default: return lex_word_or_num(t);
        }
    }

  private:
    void skip_ws_comments() {
        for (;;) {
            while (*p_ && std::isspace((unsigned char)*p_)) ++p_;
            if (p_[0] == '/' && p_[1] == '/') {
                while (*p_ && *p_ != '\n') ++p_;
            } else if (p_[0] == '/' && p_[1] == '*') {
                p_ += 2;
                while (*p_ && !(p_[0] == '*' && p_[1] == '/')) ++p_;
                if (*p_) p_ += 2;
            } else if (p_[0] == '#') {
                // directives (#include, #inputMode ...): skip the line
                while (*p_ && *p_ != '\n') ++p_;
            } else {
                return;
            }
        }
    }

    bool lex_string(Tok& t) {
        ++p_;  // opening quote
        std::string s;
        while (*p_ && *p_ != '"') {
            if (*p_ == '\\' && p_[1]) ++p_;
            s += *p_++;
        }
        if (*p_) ++p_;
        t = {Tok::STR, s};
        return true;
    }

    bool lex_word_or_num(Tok& t) {
        std::string s;
        while (*p_ && !std::isspace((unsigned char)*p_) &&
               !strchr("{}()[];\"", *p_)) {
            s += *p_++;
        }
        if (s.empty()) { ++p_; return next(t); }
        char* end = nullptr;
        double v = std::strtod(s.c_str(), &end);
        bool numeric = (end && *end == '\0');
        // OpenFOAM words may embed balanced parentheses with no whitespace:
        // grad(p), div(phi,U), div((rho*U)) are single keyword tokens
        // (fvSchemes per-term entries).  Only attach when the paren group is
        // whitespace-free — `4((0 0 0) ...)` stays a count + list.
        if (!numeric && *p_ == '(') {
            const char* q = p_;
            int depth = 0;
            bool word_form = true;
            do {
                char c2 = *q;
                if (!c2 || std::isspace((unsigned char)c2) ||
                    strchr("{}[];\"", c2)) {
                    word_form = false;
                    break;
                }
                if (c2 == '(') ++depth;
                else if (c2 == ')') --depth;
                ++q;
            } while (depth > 0);
            if (word_form) {
                s.append(p_, q - p_);
                p_ = q;
                while (*p_ && !std::isspace((unsigned char)*p_) &&
                       !strchr("{}()[];\"", *p_)) {
                    s += *p_++;
                }
                t = {Tok::WORD, s};
                return true;
            }
        }
        if (numeric) {
            t.kind = Tok::NUM;
            t.text = s;
            t.num = v;
        } else {
            t = {Tok::WORD, s};
        }
        return true;
    }

    const char* p_;
};

void json_escape(const std::string& in, std::string& out) {
    for (char c : in) {
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\n': out += "\\n"; break;
            case '\t': out += "\\t"; break;
            default:
                if ((unsigned char)c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else {
                    out += c;
                }
        }
    }
}

class Parser {
  public:
    explicit Parser(const char* text) : lex_(text) { advance(); }

    // whole input is an implicit dictionary body
    std::string parse_top() {
        std::string out;
        parse_dict_body(out);
        return out;
    }

    bool ok = true;
    std::string error;

  private:
    Lexer lex_;
    Tok cur_;
    bool have_ = false;

    void advance() { have_ = lex_.next(cur_); }

    void parse_dict_body(std::string& out) {
        out += '{';
        bool first = true;
        while (have_ && cur_.kind != Tok::RBRACE) {
            if (cur_.kind != Tok::WORD && cur_.kind != Tok::STR &&
                cur_.kind != Tok::NUM) {
                // stray token (e.g. trailing ';'): skip
                advance();
                continue;
            }
            std::string key = cur_.text;
            advance();
            if (!first) out += ',';
            first = false;
            out += '"';
            json_escape(key, out);
            out += "\":";
            if (have_ && cur_.kind == Tok::LBRACE) {
                advance();
                parse_dict_body(out);
                if (have_ && cur_.kind == Tok::RBRACE) advance();
            } else {
                parse_value_tokens(out);
            }
        }
        out += '}';
    }

    // tokens up to ';' — scalar, word, list, dimensioned scalar
    void parse_value_tokens(std::string& out) {
        std::vector<std::string> parts;
        while (have_ && cur_.kind != Tok::SEMI && cur_.kind != Tok::RBRACE) {
            parts.push_back(parse_single());
        }
        if (have_ && cur_.kind == Tok::SEMI) advance();
        if (parts.empty()) {
            out += "null";
        } else if (parts.size() == 1) {
            out += parts[0];
        } else {
            out += '[';
            for (size_t i = 0; i < parts.size(); ++i) {
                if (i) out += ',';
                out += parts[i];
            }
            out += ']';
        }
    }

    std::string parse_single() {
        std::string s;
        switch (cur_.kind) {
            case Tok::NUM:
                s = cur_.text;
                advance();
                return s;
            case Tok::WORD: {
                std::string w = cur_.text;
                advance();
                if (w == "true" || w == "yes" || w == "on") return "true";
                if (w == "false" || w == "no" || w == "off") return "false";
                s = "\"";
                json_escape(w, s);
                s += '"';
                return s;
            }
            case Tok::STR: {
                s = "\"";
                json_escape(cur_.text, s);
                s += '"';
                advance();
                return s;
            }
            case Tok::LPAREN: {
                advance();
                s = "[";
                bool first = true;
                while (have_ && cur_.kind != Tok::RPAREN) {
                    if (!first) s += ',';
                    first = false;
                    if (cur_.kind == Tok::LBRACE) {
                        advance();
                        std::string sub;
                        parse_dict_body(sub);
                        if (have_ && cur_.kind == Tok::RBRACE) advance();
                        s += sub;
                    } else {
                        s += parse_single();
                    }
                }
                if (have_) advance();  // ')'
                s += ']';
                return s;
            }
            case Tok::LBRACK: {
                // dimension set [0 2 -1 0 0 0 0] -> {"__dims__": [...]}
                advance();
                s = "{\"__dims__\":[";
                bool first = true;
                while (have_ && cur_.kind != Tok::RBRACK) {
                    if (!first) s += ',';
                    first = false;
                    s += (cur_.kind == Tok::NUM) ? cur_.text : "0";
                    advance();
                }
                if (have_) advance();  // ']'
                s += "]}";
                return s;
            }
            case Tok::LBRACE: {
                advance();
                std::string sub;
                parse_dict_body(sub);
                if (have_ && cur_.kind == Tok::RBRACE) advance();
                return sub;
            }
            default:
                advance();
                return "null";
        }
    }
};

}  // namespace

extern "C" {

char* foamdict_parse_json(const char* text) {
    Parser p(text ? text : "");
    std::string json = p.parse_top();
    char* out = (char*)std::malloc(json.size() + 1);
    std::memcpy(out, json.c_str(), json.size() + 1);
    return out;
}

void foamdict_free(char* p) { std::free(p); }

}  // extern "C"
